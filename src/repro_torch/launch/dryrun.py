"""Multi-pod dry-run: trace every (architecture x input-shape x mesh) cell on
the production mesh with meta tensors (no allocation) on a `fake` process
group of the mesh's size, and report per-device bytes, FLOPs and collective
traffic.

Counterpart of src/repro/launch/dryrun.py: the same cells (`SHAPES`,
`ASSIGNED_ARCHS`, the `shape_applicable` skips), meshes (`pod1` 16x16,
`pod2` 2x16x16) and flags. Per cell it runs, under `train_rules`, one train
step (forward, backward and AdamW, remat full unless REPRO_REMAT says
otherwise), or under `serve_rules` one `prefill` or one `decode_step`
(over a cache of seq_len positions, sharded by `cache_axes`), with bf16
parameters and caches and f32 AdamW state as DTensors. Attention runs on
each device's local shards through `kernels.ops`, whose meta route is the
plain version: the kernels are never built here.

Per cell:
- `argument_bytes`: per-device bytes of the local shards of the
  parameters, AdamW state, inputs and caches (the reference's
  `argument_size`, split by kind); `output_bytes` likewise of what the
  step returns. `temp_bytes` is null: meta tensors allocate nothing and
  eager execution has no buffer plan whose peak could be read, where XLA's
  `memory_analysis` has one.
- `flops`: per-device FLOPs, as the reference's `cost_analysis` of the
  partitioned module counts them: every matmul-class op that a device runs
  on its local tensors (`torch.utils.flop_counter`'s formulas), including
  the work it repeats on replicated operands and the remat recompute. A
  dispatch mode counts the local ops only. DTensor ops are counted at
  their global shape by `FlopCounterMode`, so the mode lets them pass and
  counts what each turns into on the local shards; the meta ops DTensor
  runs on fake tensors to propagate shapes are not counted either.
  Attention's plain version counts every (query, key) pair of its score
  matrix, as the naive and blocked attention the reference lowers do.
- `collective_bytes_per_device`: operand bytes of the functional
  collectives each device issues, under the reference's `COLLECTIVE_KINDS`
  (`distributed/collectives.py`). On the host's fake mesh DTensor turns a
  shard-to-shard move (an all-to-all on the cards) into an all-gather of
  the same operand, so those bytes stand under "all-gather".
- `wall_s`: the host time of the traced step.

`models/scan_ctl.py` and the reference's `corrected_costs` (1-unit / 2-unit
extrapolation) have no counterpart: they exist because XLA's cost analysis
counts a scanned layer body once, while the port's layer loops are eager
Python and every trip is counted. Every cell traces at full depth (80
layers for InternVL2, 48 for Llama4-Maverick).

The fake group is the process's default group, so a process that holds a
gloo or NCCL group runs the dry-run in a subprocess.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b \\
      --shape train_4k --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
Results are cached as JSON under results/dryrun_torch/ so runs are
incremental (--force recomputes).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from collections import defaultdict
from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      ShapeConfig, get_config,
                                      shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.collectives import COLLECTIVE_KINDS
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.params import ModelParams, distribute_params
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.train import make_train_step

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

ASSIGNED_ARCHS = ARCH_IDS[:10]           # the 10 assigned (paper models extra)

_C10D = torch.ops._c10d_functional
COLLECTIVE_OPS = {
    _C10D.all_gather_into_tensor.default: "all-gather",
    _C10D.all_reduce.default: "all-reduce",
    _C10D.reduce_scatter_tensor.default: "reduce-scatter",
    _C10D.all_to_all_single.default: "all-to-all",
}


class LocalCost(TorchDispatchMode):
    """Per-device cost of what runs under it: FLOPs of the matmul-class ops
    on plain (local) tensors and operand bytes of the functional
    collectives. An op on a DTensor returns NotImplemented, so DTensor
    handles it and its local ops come back here; an op on the fake tensors
    of DTensor's shape propagation runs uncounted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collective: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = COLLECTIVE_OPS.get(func)
        if kind is not None:
            self.collective[kind] += args[0].numel() * args[0].element_size()
        return out


def local_bytes(tree: Any) -> int:
    """Bytes of the local shards (whole tensors for plain ones) of every
    tensor in a tree of dicts, tuples and `ModelParams`."""
    if isinstance(tree, ModelParams):
        tree = tree.leaves()
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    return total


def _meta_params(cfg: ModelConfig, trainable: bool,
                 dtype=torch.bfloat16) -> ModelParams:
    def make(shapes):
        if isinstance(shapes, dict):
            return {k: make(s) for k, s in shapes.items()}
        return torch.empty(shapes, device="meta", dtype=dtype)
    return ModelParams(make(M.model_shapes(cfg)), trainable=trainable)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rules: shd.ShardingRules,
                param_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta stand-ins of every model input of the cell, placed by
    act_batch: tokens (and labels) int32, vision embeddings or audio frames
    in the parameters' dtype; for decode, one token a row (the cache is
    made under `use_sharding` by `init_cache`)."""
    sizes = shd.axis_sizes(mesh)
    B, S = shape.global_batch, shape.seq_len

    def place(shp, dtype):
        t = torch.empty(shp, device="meta", dtype=dtype)
        dims = ("act_batch",) + (None,) * (len(shp) - 1)
        return shd.distribute(t, mesh, shd.placements(shp, dims, sizes,
                                                      rules))
    if shape.kind == "decode":
        return {"tokens": place((B,), torch.int32)}
    batch = {"tokens": place((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = place((B, S), torch.int32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = place((B, cfg.num_patches, cfg.d_model),
                                       param_dtype)
    if cfg.family == "audio":
        batch["frames"] = place((B, cfg.encoder_seq, cfg.d_model),
                                param_dtype)
    return batch


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules: shd.ShardingRules) -> Dict[str, Any]:
    """One cell's step on meta DTensors; returns its per-device bytes,
    FLOPs and collective bytes and the wall time."""
    train = shape.kind == "train"
    params = distribute_params(_meta_params(cfg, train), cfg, mesh, rules)
    batch = input_specs(cfg, shape, mesh, rules)
    args: Dict[str, Any] = {"params": params, "inputs": batch}
    t0 = time.monotonic()
    with shd.use_sharding(mesh, rules), LocalCost() as cost:
        if train:
            state = init_state(params)
            args["opt_state"] = state
            step = make_train_step(cfg, AdamWConfig(),
                                   remat=os.environ.get("REPRO_REMAT",
                                                        "full"))
            out = step(params, state, batch)
        elif shape.kind == "prefill":
            out = M.prefill(params, cfg, batch, max_seq=shape.seq_len,
                            cache_dtype=torch.bfloat16)
        else:
            cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 torch.bfloat16, "meta")
            cache["pos"] = shape.seq_len - 1     # the last slot: all keys
            args["cache"] = {k: v for k, v in cache.items() if k != "pos"}
            out = M.decode_step(params, cfg, batch["tokens"], cache)
    wall = time.monotonic() - t0
    coll = {k: int(cost.collective.get(k, 0)) for k in COLLECTIVE_KINDS}
    return {
        "argument_bytes": {k: local_bytes(v) for k, v in args.items()},
        "argument_size_bytes": sum(local_bytes(v) for v in args.values()),
        "output_bytes": local_bytes(out),
        "temp_bytes": None,
        "flops": float(cost.flops),
        "collective_bytes_per_device": coll,
        "collective_total": int(sum(coll.values())),
        "wall_s": round(wall, 3),
    }


def count(fn: Callable[[], Any]) -> Tuple[int, Dict[str, int]]:
    """(per-device FLOPs, {collective kind: operand bytes}) of fn()."""
    with LocalCost() as cost:
        fn()
    return cost.flops, dict(cost.collective)


def fake_world(n: int) -> None:
    """Make the process's default group a `fake` one of n ranks (this
    process is rank 0), replacing an earlier fake group of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running: run the "
                               "dry-run in a process of its own")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False) -> Dict[str, Any]:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    mesh_name = "pod2" if multi_pod else "pod1"
    out_path = os.path.join(RESULTS_DIR,
                            f"{arch}__{shape_name}__{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "kind": shape.kind}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        result.update(status="skipped", reason=why)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
        return result

    rules = (shd.train_rules(multi_pod=multi_pod) if shape.kind == "train"
             else shd.serve_rules(multi_pod=multi_pod))
    try:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        result.update(status="ok", devices=math.prod(mesh.shape),
                      **trace_cell(cfg, shape, mesh, rules))
        print(f"[ok] {arch} {shape_name} {mesh_name}: "
              f"flops={result['flops']:.3e} "
              f"args={result['argument_size_bytes']:.3e}B "
              f"coll={result['collective_total']:.3e}B "
              f"wall={result['wall_s']:.1f}s", flush=True)
    except Exception as e:  # noqa: BLE001 - a cell's failure is its result
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        print(f"[ERROR] {arch} {shape_name} {mesh_name}: {e}", flush=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]

    n_ok = n_err = n_skip = 0
    for mp in meshes:
        for arch in archs:
            for shape_name in shapes:
                r = run_cell(arch, shape_name, mp, force=args.force)
                n_ok += r["status"] == "ok"
                n_err += r["status"] == "error"
                n_skip += r["status"] == "skipped"
    print(f"\ndry-run summary: ok={n_ok} skipped={n_skip} errors={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
