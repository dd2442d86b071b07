"""The port's dry-run (`repro_torch.launch.dryrun`) over the cells of the
reference's tests/test_dryrun_small.py, on a `fake` process group in a
subprocess (the group is the process's default one): tiny configs, batch 4,
sequence at most 64 (that file's sizes), every `FAMILY_REPS` arch at
train_4k on a 2x2 (data, model) mesh, prefill_32k, decode_32k and long_500k
for llama3_2_1b and mamba2_370m with the same skip, and llama3_2_1b at
train_4k on 2x2x2 (pod, data, model). Each cell must report `ok` and FLOPs
> 0, and its per-device parameter bytes must equal the sum of the local
shard sizes that the reference's `spec_for` gives each leaf. A hand-counted
case holds the FLOP counter to a product with a sharded operand and one
with replicated operands, per device, on a 2x2 mesh.

    PYTHONPATH=src python -m pytest tests/test_torch_dryrun.py -q
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs.base import get_tiny_config
from repro.distributed import sharding as ref
from repro.models import model as RM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILY_REPS = ["llama3_2_1b", "qwen3_30b_a3b", "mamba2_370m",
               "recurrentgemma_9b", "whisper_large_v3", "internvl2_76b"]
CELLS = ([(a, "train_4k", False) for a in FAMILY_REPS]
         + [(a, s, False) for s in ("prefill_32k", "decode_32k", "long_500k")
            for a in ("llama3_2_1b", "mamba2_370m")]
         + [("llama3_2_1b", "train_4k", True)])

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs.base import SHAPES, get_tiny_config, shape_applicable
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh

    out = {}
    for arch, shape_name, multi_pod in json.loads(sys.argv[1]):
        cfg = get_tiny_config(arch)
        shape = dataclasses.replace(SHAPES[shape_name], global_batch=4,
                                    seq_len=min(SHAPES[shape_name].seq_len, 64))
        key = f"{arch}/{shape_name}/{'pod2' if multi_pod else 'pod1'}"
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            out[key] = {"status": "skipped", "reason": why}
            continue
        dryrun.fake_world(8 if multi_pod else 4)
        mesh = make_debug_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = (shd.train_rules(multi_pod=multi_pod) if shape.kind == "train"
                 else shd.serve_rules(multi_pod=multi_pod))
        try:
            out[key] = dict(status="ok", **dryrun.trace_cell(cfg, shape, mesh,
                                                             rules))
        except Exception as e:
            out[key] = {"status": "error", "error": f"{type(e).__name__}: {e}"}

    # hand-counted FLOPs on a 2x2 mesh
    dryrun.fake_world(4)
    mesh = make_debug_mesh(device_type="cpu")
    a = torch.empty(8, 64, device="meta")
    b = torch.empty(64, 128, device="meta")
    sa = distribute_tensor(a, mesh, [Shard(0), Replicate()])
    sb = distribute_tensor(b, mesh, [Replicate(), Shard(1)])
    ra = distribute_tensor(a, mesh, [Replicate(), Replicate()])
    rb = distribute_tensor(b, mesh, [Replicate(), Replicate()])
    out["hand"] = {"sharded": dryrun.count(lambda: sa @ sb),
                   "replicated": dryrun.count(lambda: ra @ rb),
                   "plain": dryrun.count(lambda: a @ b)}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def results():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(CELLS)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def reference_param_bytes(arch, multi_pod, kind):
    """Per-device bytes of the bf16 parameters' local shards, from the
    reference's `spec_for` on a stand-in of the debug mesh."""
    class StandIn:
        shape = ({"pod": 2, "data": 2, "model": 2} if multi_pod
                 else {"data": 2, "model": 2})
    cfg = get_tiny_config(arch)
    rules = (ref.train_rules(multi_pod=multi_pod) if kind == "train"
             else ref.serve_rules(multi_pod=multi_pod))

    def walk(axes, shapes):
        if isinstance(axes, dict):
            return sum(walk(axes[k], shapes[k]) for k in axes)
        spec = ref.spec_for(tuple(shapes), axes, StandIn, rules)
        n = 1
        for size, entry in zip(shapes, spec):
            n *= size // ref._axis_size(StandIn, entry)
        return 2 * n
    return walk(RM.param_axes(cfg), RM.model_shapes(cfg))


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_cell_traces(results, arch, shape, multi_pod):
    r = results[f"{arch}/{shape}/{'pod2' if multi_pod else 'pod1'}"]
    if r["status"] == "skipped":
        # the reference's one skip: long_500k on full attention
        assert shape == "long_500k" and arch == "llama3_2_1b", r
        return
    assert r["status"] == "ok", r
    assert r["flops"] > 0, r
    kind = "train" if shape == "train_4k" else "serve"
    assert r["argument_bytes"]["params"] == \
        reference_param_bytes(arch, multi_pod, kind), r
    if kind == "train":           # AdamW m and v: f32 copies of the shards
        assert r["argument_bytes"]["opt_state"] == \
            4 * r["argument_bytes"]["params"] + 4, r


def test_flop_count_is_per_device(results):
    """(8, 64) @ (64, 128): 2*8*64*128 = 131072 FLOPs in all. Rows sharded
    over data and columns over model leave each device a (4, 64) @ (64, 64)
    product, 32768; replicated operands make every device compute the whole
    product, 131072 each, as a partitioned module's cost analysis counts."""
    hand = results["hand"]
    assert hand["plain"] == [2 * 8 * 64 * 128, {}]
    assert hand["sharded"] == [2 * 4 * 64 * 64, {}]
    assert hand["replicated"] == [2 * 8 * 64 * 128, {}]
    assert math.prod((2, 2)) * hand["sharded"][0] == hand["plain"][0]
