"""The port's sharded path on a real 4-process `gloo` group on the CPU: a
(data 2, model 2) mesh, tiny configs on weights bridged from the JAX
reference's `init_params`, each run sharded against the same run of the
unsharded port.

- Llama3.2-1B: under `train_rules` one train step's loss and every updated
  leaf (parameters, AdamW m and v) within 2e-5; under `serve_rules` a
  `prefill` and 8 greedy `decode_step`s with equal tokens and logits and
  caches within 2e-5; a checkpoint saved unsharded and restored with
  `placements=` equal to the saved leaves exactly.
- Qwen3-MoE (the experts sharded over `model`, each rank's partial combine
  summed) and RecurrentGemma (one KV head on a 2-way `model` axis: the
  query heads stay sharded and k/v's gradients sum across it; the RG-LRU
  scan and the conv on sharded channels): the loss, the gradients' AdamW
  moments m and v, tokens, logits and caches likewise. Their updated
  parameters are not compared: the first AdamW step divides each gradient
  by its own magnitude, so a gradient near 0 turns a 1e-9 difference into
  an update of up to the learning rate.

The unsharded port is held against JAX in tests/test_torch_training.py,
tests/test_torch_model.py, tests/test_torch_moe.py and
tests/test_torch_recurrent.py, which closes the chain to the reference.

Each rank is a fresh interpreter (`python -c`, as a spawned process is)
that meets the others through a `FileStore` under the test's tmp_path, on
one intra-op thread, under one timeout for the group.

    PYTHONPATH=src python -m pytest tests/test_torch_distributed.py -q
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.models import init_params as jax_init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 300            # seconds for the whole group; a hang fails
TOL = 2e-5
ARCHS = ["llama3_2_1b", "qwen3_30b_a3b", "recurrentgemma_9b"]

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs.base import get_tiny_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.params import distribute_params, from_jax_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                                init_state, opt_state_axes)
    from repro_torch.training.train import make_train_step

    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{tmp}/store", world), rank=rank,
        world_size=world)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    sizes = shd.axis_sizes(mesh)
    B, S = 4, 24

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def err(a, b):
        return float((full(a) - b).abs().max())

    def load(arch):
        with np.load(f"{tmp}/{arch}.npz") as f:
            flat = {k: f[k] for k in f.files}
        tree = {}
        for path, a in flat.items():
            *groups, name = path.split("/")
            node = tree
            for g in groups:
                node = node.setdefault(g, {})
            node[name] = a
        return tree

    def batch_of(rules, sharded, **arrays):
        out = {}
        for k, a in arrays.items():
            t = torch.as_tensor(a)
            if sharded:
                dims = ("act_batch",) + (None,) * (t.dim() - 1)
                t = shd.distribute(t, mesh, shd.placements(
                    tuple(t.shape), dims, sizes, rules))
            out[k] = t
        return out

    def check(arch):
        cfg, tree = get_tiny_config(arch), load(arch)
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                 (B, S + 1))
        out = {}

        # --- one train step -----------------------------------------------
        opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=40)
        step = make_train_step(cfg, opt, remat="full")
        rules = shd.train_rules()
        arrays = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
        p0 = from_jax_params(tree, device="cpu", trainable=True)
        s0 = init_state(p0)
        p0, s0, m0 = step(p0, s0, batch_of(rules, False, **arrays))
        p1 = distribute_params(from_jax_params(tree, device="cpu",
                                               trainable=True),
                               cfg, mesh, rules)
        s1 = init_state(p1)
        with shd.use_sharding(mesh, rules):
            p1, s1, m1 = step(p1, s1, batch_of(rules, True, **arrays))
        want, got = p0.leaves(), p1.leaves()
        out["train"] = {
            "loss": err(m1["loss"], m0["loss"]),
            "params": max(err(got[k], want[k]) for k in want),
            "m": max(err(s1.m[k], s0.m[k]) for k in want),
            "v": max(err(s1.v[k], s0.v[k]) for k in want),
            "sharded_leaves": sum(any(not isinstance(p, Replicate)
                                      for p in t.placements)
                                  for t in got.values()),
            "leaves": len(want)}

        # --- prefill + 8 greedy decode steps ------------------------------
        rules = shd.serve_rules()
        n_steps = 8
        q0 = from_jax_params(tree, device="cpu")
        q1 = distribute_params(q0, cfg, mesh, rules)

        def greedy(params, sharded):
            with shd.use_sharding(mesh if sharded else None, rules):
                logits, cache = M.prefill(
                    params, cfg, batch_of(rules, sharded,
                                          tokens=toks[:, :S]),
                    max_seq=S + n_steps, cache_dtype=torch.float32)
                seen, tokens = [full(logits)], []
                for _ in range(n_steps):
                    nxt = seen[-1].argmax(-1)
                    tokens.append(nxt.tolist())
                    logits, cache = M.decode_step(
                        params, cfg, batch_of(rules, sharded, t=nxt)["t"],
                        cache)
                    seen.append(full(logits))
            return seen, tokens, cache

        l0, t0, c0 = greedy(q0, False)
        l1, t1, c1 = greedy(q1, True)
        leaves = [k for k in c0 if k != "pos"]
        out["serve"] = {
            "tokens_equal": t0 == t1,
            "logits": max(float((a - b).abs().max())
                          for a, b in zip(l1, l0)),
            "cache": max(err(c1[k], c0[k]) for k in leaves),
            "cache_placements": {k: [str(p) for p in c1[k].placements]
                                 for k in leaves}}
        return out, (p0, s0, got)

    report = {}
    for arch in json.loads(sys.argv[4]):
        report[arch], kept = check(arch)
        if arch == "llama3_2_1b":
            llama = kept

    # --- a checkpoint saved unsharded, restored onto the mesh -------------
    p0, s0, got = llama
    cfg = get_tiny_config("llama3_2_1b")
    rules = shd.train_rules()
    d = f"{tmp}/ckpt"
    if rank == 0:
        ckpt.save(d, 1, {"params": p0, "opt_state": s0})
    dist.barrier()
    axes = M.param_axes(cfg)
    o_axes = opt_state_axes(axes)
    want = p0.leaves()
    o_place = {k: shd.placements(tuple(t.shape), o_axes.m[k], sizes, rules)
               for k, t in want.items()}
    place = {"params": shd.tree_placements(axes, M.model_shapes(cfg), sizes,
                                           rules),
             "opt_state": AdamWState(step=[Replicate()] * 2, m=o_place,
                                     v=dict(o_place))}
    back = ckpt.restore(d, 1, {"params": p0, "opt_state": s0}, mesh=mesh,
                        placements=place)
    bp, bs = back["params"].leaves(), back["opt_state"]
    report["checkpoint"] = {
        "equal": all(torch.equal(full(bp[k]), want[k]) and
                     torch.equal(full(bs.m[k]), s0.m[k]) and
                     torch.equal(full(bs.v[k]), s0.v[k]) for k in want)
        and torch.equal(full(bs.step), s0.step),
        "placements_match": all(
            tuple(bp[k].placements) == tuple(got[k].placements)
            for k in want),
        "dtensors": all(isinstance(t, DTensor) for t in bp.values())}
    dist.barrier()
    if rank == 0:
        with open(f"{tmp}/report.json", "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    for arch in ARCHS:
        flat = jax.tree_util.tree_flatten_with_path(
            jax_init_params(jax_tiny_config(arch), jax.random.PRNGKey(0)))[0]
        np.savez(tmp / f"{arch}.npz", **{
            "/".join(str(k.key) for k in path): np.asarray(x, np.float32)
            for path, x in flat})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(WORLD), str(tmp),
         json.dumps(ARCHS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {out[-3000:]}"
    with open(tmp / "report.json") as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_unsharded(report, arch):
    r = report[arch]["train"]
    assert max(r["loss"], r["m"], r["v"]) <= TOL, r
    if arch == "llama3_2_1b":
        assert r["params"] <= TOL, r
    assert r["sharded_leaves"] >= r["leaves"] // 3, r   # really sharded


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(report, arch):
    r = report[arch]["serve"]
    assert r["tokens_equal"], r
    assert r["logits"] <= TOL and r["cache"] <= TOL, r
    if arch == "llama3_2_1b":
        # serve_rules shard the K/V cache's batch over `data` and its
        # sequence over `model`
        assert r["cache_placements"]["k"] == ["S(1)", "S(2)"], r


def test_checkpoint_restores_onto_the_mesh(report):
    r = report["checkpoint"]
    assert r["equal"] and r["dtensors"] and r["placements_match"], r
