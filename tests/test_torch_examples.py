"""The PyTorch port's examples (`examples/*_torch.py`) on the CPU, at the
JAX examples' tiny configs in f32: the simulator mode of the cluster
example and the goodput sweep print exactly what the JAX examples print on
the same arguments; the quickstart preempts A and resumes it bit-exactly;
the cluster example's real mode (3 prefill instances, 2 decode instances
with migration) recovers every request of a chaos run with its first token
equal to a fault-free run's; the training example's losses stay within
1e-4 relative of the JAX example's loop on the same weights and batches,
and a run killed after a checkpoint resumes `torch.equal` to a straight
run. The examples have no `__init__`, so each is loaded by path.

    PYTHONPATH=src python -m pytest tests/test_torch_examples.py -q
"""
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import data_iterator as jax_data_iterator
from repro.training.optimizer import AdamWConfig as JaxAdamWConfig
from repro.training.optimizer import init_state as jax_init_state
from repro.training.train import LoopConfig as JaxLoopConfig
from repro.training.train import make_train_step as jax_make_train_step
from repro.training.train import train_loop as jax_train_loop
from repro_torch.core import TTFTPredictor
from repro_torch.core.faults import FaultEvent, FaultPlan
from repro_torch.launch.serve import draw_params
from repro_torch.models.segments import SegmentedPrefill
from repro_torch.params import from_jax_params

# chip_smoke.py (which imports only the standard library at import time)
# loads the examples and holds a prefill worker for phase 18; the tests use
# the same two helpers
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
load = chip_smoke.load_example


# --- simulator mode: the same tables as the JAX examples -----------------------

SIM = ["--duration", "6", "--rate", "8"]


@pytest.mark.parametrize("flags", [["--policy", "all"], ["--chaos", "churn"],
                                   ["--spec-decode"],
                                   ["--hetero", "a800,a100"]],
                         ids=["policy-all", "chaos-churn", "spec-decode",
                              "hetero"])
def test_cluster_sim_mode_prints_the_reference_table(flags, capsys,
                                                     monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve_cluster.py", *SIM, *flags])
    load("serve_cluster").main()
    want = capsys.readouterr().out
    load("serve_cluster_torch").main(SIM + flags)
    got = capsys.readouterr().out
    assert "per-instance dispatched" in want
    assert got == want


def test_goodput_sweep_prints_the_reference_table(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["simulate_goodput.py", "--duration",
                                      "4"])
    load("simulate_goodput").main()
    want = capsys.readouterr().out
    load("simulate_goodput_torch").main(["--duration", "4"])
    assert capsys.readouterr().out == want
    assert "FlowPrefill goodput ratios" in want


# --- the quickstart -------------------------------------------------------------


def test_quickstart_preempts_a_and_resumes_it_bit_exact():
    """The walkthrough on the example's executor, with a predictor at a
    nominal 1e-4 s a token (as tests/test_torch_faults.py's) in place of
    the measured profile: timed under the suite's load, a profile can make
    B look doomed, and S-EDF rightly preempts nothing for a doomed
    request."""
    qs = load("quickstart_torch")
    cfg = qs.config()
    params = draw_params(cfg, "cpu", 0)
    ex = SegmentedPrefill(params, cfg, max_seq=qs.MAX_SEQ, granularity="op",
                          chunk_tokens=512)
    pred = TTFTPredictor(coeffs=np.array([1e-4, 0.0]), floor=0.0)
    res = qs.walkthrough(params, cfg, ex, pred)
    assert res["a"].first_token_time is not None
    assert res["b"].first_token_time is not None
    assert res["preemptions"] >= 1
    assert res["bit_exact"]
    assert res["a_logits"].shape == (1, cfg.vocab_size)


def test_the_examples_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("quickstart_torch").main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("serve_cluster_torch").main(["--real"])


# --- the cluster example's real mode under chaos ---------------------------------


def test_cluster_real_mode_recovers_every_request(tmp_path):
    """3 prefill instances, 2 decode instances with migration (decode
    batch 4), 6 requests under least-loaded dispatch: a fault-free run,
    then the same prompts under a plan that crashes prefill[0] and
    decode[0] mid-trace. Least-loaded breaks ties toward instance 0, so
    request 0 lands on prefill[0], which holds it until the crash
    strands it."""
    cl_mod = load("serve_cluster_torch")
    plan = FaultPlan(events=(
        FaultEvent(time=15.0, instance=0, kind="crash", duration=2.0),
        FaultEvent(time=25.0, instance=0, kind="crash", duration=2.0,
                   target="decode")))
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    base = ["--real", "--device", "cpu", "--instances", "3", "--requests",
            "6", "--policy", "least-loaded", "--decode-migration",
            "--decode-max-batch", "4"]
    args = cl_mod.parser().parse_args(base)
    cfg, params, ex, profile = cl_mod.load_model(args)
    runs = {}
    for name, extra in (("fault-free", []), ("chaos", ["--chaos",
                                                        str(path)])):
        args = cl_mod.parser().parse_args(base + extra)
        cl = cl_mod.Cluster(args, cfg, params, ex, profile)
        if cl.plan is not None:
            chip_smoke.hold_until_crash(cl.insts[0])
        try:
            rep, reqs = cl_mod.serve(args, cl, drain_timeout=120.0)
            runs[name] = (rep, reqs, cl.prefill_logits(reqs))
        finally:
            cl.shutdown()
    for name, (rep, reqs, logits) in runs.items():
        assert rep["n_requests"] == 6, name
        assert rep["stranded_rids"] == [], name
        assert rep["lost_requests"] == 0, name
        assert all(r.finish_time is not None for r in reqs), name
        assert all(rows for rows in logits), name
    assert runs["fault-free"][0]["retries"] == 0
    assert runs["chaos"][0]["retries"] >= 1
    want = [int(rows[0].argmax()) for rows in runs["fault-free"][2]]
    got = [sorted({int(row.argmax()) for row in rows})
           for rows in runs["chaos"][2]]
    assert got == [[t] for t in want]


# --- the training example ---------------------------------------------------------


def _losses(lines):
    return [float(m.group(1)) for line in lines
            for m in [re.search(r"loss=([-0-9.]+)", line)] if m]


def test_train_example_matches_the_jax_example_loop(tmp_path):
    """Five steps of the JAX example's loop (its tiny config, its AdamW and
    data, `train_loop`) and of the port's, from the same weights (the JAX
    `init_params(cfg, PRNGKey(0))` bridged by `from_jax_params`): every
    logged loss within 1e-4 relative (tests/test_torch_training.py's)."""
    tq = load("train_quickstart_torch")
    cfg = tq.config()
    jcfg = jax_tiny_config("llama3_8b")
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    steps = 5
    jlog = []
    jax_train_loop(
        jcfg, jax.tree.map(jax.numpy.asarray, tree),
        jax_init_state(jax.tree.map(jax.numpy.asarray, tree)),
        jax.jit(jax_make_train_step(
            jcfg, JaxAdamWConfig(lr=3e-3, warmup_steps=10,
                                 total_steps=steps), remat="none")),
        jax_data_iterator(JaxDataConfig(seq_len=64, global_batch=8,
                                        vocab_size=jcfg.vocab_size)),
        JaxLoopConfig(total_steps=steps, checkpoint_every=20,
                      checkpoint_dir=str(tmp_path / "jax"), log_every=1),
        log=jlog.append)
    log = []
    params = from_jax_params(tree, device="cpu", trainable=True)
    tq.train(cfg, params, steps=steps, ckpt_dir=str(tmp_path / "port"),
             log_every=1, log=log.append)
    want, got = _losses(jlog), _losses(log)
    assert len(want) == len(got) == steps
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.fixture
def deterministic():
    """Deterministic kernels for the block (the embedding gradient's
    accumulation order on the CPU varies with its threads otherwise), as
    the training example runs them."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def test_train_example_resumes_bit_exact_after_a_kill(tmp_path,
                                                      deterministic):
    """8 steps straight against a run killed at step 6 (after the step-4
    checkpoint) and rerun: the rerun resumes from step 4, and every
    parameter and AdamW moment is `torch.equal` to the straight run's."""
    tq = load("train_quickstart_torch")
    cfg = tq.config()
    kw = dict(steps=8, checkpoint_every=4, log_every=1)
    p_full, s_full, _ = tq.train(cfg, tq.draw(cfg, "cpu"),
                                 ckpt_dir=str(tmp_path / "straight"),
                                 log=lambda msg: None, **kw)

    class Killed(Exception):
        pass

    def kill_at_6(msg):
        if msg.startswith("step 6:"):
            raise Killed

    run = str(tmp_path / "killed")
    with pytest.raises(Killed):
        tq.train(cfg, tq.draw(cfg, "cpu"), ckpt_dir=run, log=kill_at_6, **kw)
    log = []
    params, state, _ = tq.train(cfg, tq.draw(cfg, "cpu"), ckpt_dir=run,
                                log=log.append, **kw)
    assert log[0] == "auto-resumed from checkpoint step 4"
    pairs = [(p_full.leaves(), params.leaves()), (s_full.m, state.m),
             (s_full.v, state.v)]
    for want, got in pairs:
        assert want.keys() == got.keys()
        for key in want:
            assert torch.equal(want[key], got[key]), key
    assert int(state.step) == int(s_full.step) == 8
