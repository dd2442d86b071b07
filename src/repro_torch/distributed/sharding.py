"""Logical-axis sharding (MaxText-style rules) on a `DeviceMesh`.

Model code tags tensors with *logical* dimension names via
``logical(x, *dims)``. A rule set maps logical dims to mesh axes. Outside a
mesh context the tag is the identity, so the same model code runs on one
device and on a 512-device mesh. Inside one (`use_sharding`), the tag
redistributes the DTensor `x` to the rule's placements: one `Shard(d)` or
`Replicate()` per mesh dim.

Counterpart of src/repro/distributed/sharding.py, with its names and rules
unchanged. A reference PartitionSpec entry for tensor dim d becomes
`Shard(d)` on each mesh dim the entry names, `Replicate()` on the others.

Divisibility guard, as the reference's: if a tensor dim is not divisible by
the mapped mesh-axis size (e.g. kv_heads=2 on a 16-way model axis), that dim
falls back to replication, and a mesh axis already used by an earlier dim
is dropped. DTensor itself would shard unevenly without complaint, so the
guard is what keeps the layout equal to GSPMD's.

A multi-axis entry such as ("pod", "data") splits its dim major-to-minor
in the entry's order, as JAX does. DTensor splits a dim over several mesh
dims in mesh-dim order, so `placements` raises for an entry whose axes are
not in mesh-dim order (every rule here lists them so).

The pure part, `spec_for` and `placements`, reads only a ``{axis: size}``
mapping in mesh-dim order and needs no mesh or process group.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

AxisVal = Union[None, str, Tuple[str, ...]]

_CTX = threading.local()


@dataclass(frozen=True)
class ShardingRules:
    """Mapping of logical dim names to mesh axis names."""

    rules: Dict[str, AxisVal] = field(default_factory=dict)

    def get(self, name: str) -> AxisVal:
        return self.rules.get(name)

    def with_overrides(self, **kw: AxisVal) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(d)


def train_rules(multi_pod: bool = False, fsdp: bool = True) -> ShardingRules:
    """DP(+pod) over batch, FSDP over d_model param dim, TP over heads/ff/vocab,
    EP over experts."""
    batch: AxisVal = ("pod", "data") if multi_pod else "data"
    return ShardingRules({
        # --- activations ---
        "act_batch": batch,
        "act_seq": None,
        "act_d": None,
        "act_heads": "model",
        "act_ff": "model",
        "act_vocab": "model",
        "act_exp": "model",
        # --- params ---
        "d_model": "data" if fsdp else None,   # FSDP shard dim (within pod)
        "heads_x_hd": "model",                  # (H*hd) projection dim
        "kv_x_hd": None,                        # K/V proj replicated (K < TP)
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "layers": None,
        "lru": "model",
        "ssm_inner": "model",
        # --- caches ---
        "cache_batch": batch,
        "cache_seq": None,
        "cache_kv_heads": "model",
        # --- optimizer (ZeRO) ---
        "zero": "data",
    })


def serve_rules(multi_pod: bool = False,
                decode_seq_shard: bool = True) -> ShardingRules:
    """Serving: weight-stationary TP over 'model'; batch DP over 'data';
    decode KV caches sequence-sharded over 'model' (flash-decode style) so
    GQA kv_heads < TP degree still scales."""
    batch: AxisVal = ("pod", "data") if multi_pod else "data"
    return ShardingRules({
        "act_batch": batch,
        "act_seq": None,
        "act_d": None,
        "act_heads": "model",
        "act_ff": "model",
        "act_vocab": "model",
        "act_exp": "model",
        "d_model": None,                         # weights not FSDP-sharded when serving
        "heads_x_hd": "model",
        "kv_x_hd": None,
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "experts": "model",
        "layers": None,
        "lru": "model",
        "ssm_inner": "model",
        "cache_batch": batch,
        "cache_seq": "model" if decode_seq_shard else None,
        "cache_kv_heads": None if decode_seq_shard else "model",
        "zero": None,
    })


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


@contextmanager
def use_sharding(mesh, rules: Optional[ShardingRules]):
    """Within the block, `logical` redistributes to `rules` on `mesh` (a
    `DeviceMesh` with named dims); with mesh None it is the identity. With
    a mesh, a plain tensor that meets a DTensor in an op counts as
    replicated (DTensor's `implicit_replication`): the model's positions,
    masks and lengths are such tensors, the same on every rank, as the
    reference's constants are under GSPMD."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, rules) if mesh is not None else None
    try:
        if mesh is None:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _CTX.state = prev


def current():
    """(mesh, rules) of the innermost `use_sharding`, or None."""
    return getattr(_CTX, "state", None)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, in mesh-dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(shape: Mapping[str, int], axis: AxisVal) -> int:
    if axis is None:
        return 1
    if isinstance(axis, str):
        return shape[axis]
    return math.prod(shape[a] for a in axis)


def spec_for(shape: Tuple[int, ...], dims: Tuple[Optional[str], ...],
             mesh_shape: Mapping[str, int],
             rules: ShardingRules) -> Tuple[AxisVal, ...]:
    """The reference's PartitionSpec entries, one per tensor dim, dropping
    axes that don't divide the dim or that an earlier dim already uses."""
    assert len(shape) == len(dims), (shape, dims)
    out: List[AxisVal] = []
    used: set = set()
    for size, name in zip(shape, dims):
        ax = rules.get(name) if name else None
        if ax is not None:
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            if any(a in used for a in axes):
                ax = None
            elif size % _axis_size(mesh_shape, ax) != 0:
                ax = None
            else:
                used.update(axes)
        out.append(ax)
    return tuple(out)


def _spec_placements(spec: Tuple[AxisVal, ...],
                    mesh_shape: Mapping[str, int]) -> List[Placement]:
    """PartitionSpec entries as DTensor placements, one per mesh dim."""
    names = list(mesh_shape)
    out: List[Placement] = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"entry {ax} of dim {d} is not in mesh-dim "
                             f"order {names}: DTensor would split the dim "
                             "in another order than JAX")
        for i in idx:
            out[i] = Shard(d)
    return out


def placements(shape: Tuple[int, ...], dims: Tuple[Optional[str], ...],
               mesh_shape: Mapping[str, int],
               rules: ShardingRules) -> List[Placement]:
    """The placements `logical(x, *dims)` gives an x of `shape`. A dim of
    length 1, which only mesh axes of size 1 can divide, stays replicated:
    DTensor cannot flatten a sharded dim of length 1 into its neighbour (a
    batch of one row through a matmul)."""
    out = _spec_placements(spec_for(shape, dims, mesh_shape, rules),
                          mesh_shape)
    return [Replicate() if isinstance(p, Shard) and shape[p.dim] == 1 else p
            for p in out]


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """x itself if it is a DTensor, else x as replicated on every rank (the
    caller holds the same values on each)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def logical(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """Tag an activation with logical dims: inside `use_sharding`,
    redistribute it to the rule's placements (a plain tensor counts as
    replicated); outside, the identity."""
    state = current()
    if state is None:
        return x
    mesh, rules = state
    place = placements(tuple(x.shape), dims, axis_sizes(mesh), rules)
    x = as_dtensor(x, mesh)
    if tuple(x.placements) == tuple(place):
        return x
    return x.redistribute(mesh, place)


def _is_dims(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in t)


def tree_placements(axes_tree: Any, shapes_tree: Any, mesh_shape: Mapping,
                    rules: ShardingRules) -> Any:
    """Map a tree (nested dicts) of logical-dim tuples and a tree of the
    same structure of shapes to placements: the counterpart of the
    reference's `tree_specs` / `tree_shardings`."""
    if _is_dims(axes_tree):
        return placements(tuple(shapes_tree), axes_tree, mesh_shape, rules)
    return {k: tree_placements(v, shapes_tree[k], mesh_shape, rules)
            for k, v in axes_tree.items()}


def distribute(x: torch.Tensor, mesh, place) -> DTensor:
    """x, the same whole tensor on every rank, as a DTensor with placements
    `place`: each rank keeps its own block (a contiguous copy) and nothing
    is communicated. On the meta device only shapes are computed."""
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh,
                                                          place)
    local = x[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.contiguous(), mesh, place,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def distribute_tree(tree: Any, axes_tree: Any, mesh=None,
                    rules: Optional[ShardingRules] = None) -> Any:
    """A tree (nested dicts) of whole tensors as DTensors placed by the
    logical dims of `axes_tree` (`param_axes`, `cache_axes`) under `rules`
    on `mesh`: by default the active `use_sharding`'s. A key of `tree`
    missing from `axes_tree` (the cache's int "pos") stays as it is."""
    if mesh is None:
        mesh, rules = current()
    sizes = axis_sizes(mesh)

    def go(t, axes):
        if isinstance(t, torch.Tensor):
            return distribute(t, mesh, placements(tuple(t.shape), axes,
                                                  sizes, rules))
        return {k: go(v, axes[k]) if k in axes else v for k, v in t.items()}
    return go(tree, axes_tree)


def write_seq(dst: torch.Tensor, start: int, src: torch.Tensor) -> None:
    """dst[:, start:start + S] = src in place, for dst (B, T, ...) and src
    (B, S, ...). On a DTensor dst, src is first redistributed to dst's
    placements with its dim 1 replicated, and each rank writes the part of
    [start, start + S) that its own block of dst holds: a cache sharded
    over its sequence (`cache_seq` under `serve_rules`) is written where it
    lies, where an indexed write into the DTensor would write a gathered
    copy and lose it."""
    S = src.shape[1]
    if not isinstance(dst, DTensor):
        dst[:, start:start + S] = src
        return
    mesh = dst.device_mesh
    place = [Replicate() if p == Shard(1) else p for p in dst.placements]
    src = as_dtensor(src, mesh).redistribute(mesh, place).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo, hi = max(start, offset[1]), min(start + S, offset[1] + shape[1])
    if lo < hi:
        dst.to_local()[:, lo - offset[1]:hi - offset[1]] = \
            src[:, lo - start:hi - start]


def unflatten(x: torch.Tensor, dim: int, sizes: Tuple[int, ...]):
    """x.unflatten(dim, sizes). A DTensor sharded on `dim` over mesh dims
    whose product does not divide sizes[0] (a K/V projection of 8 heads
    sharded 16 ways) is first replicated on them: DTensor cannot split a
    shard across the new dims, where GSPMD re-tiles."""
    if isinstance(x, DTensor):
        d = dim % x.dim()
        mesh = x.device_mesh
        ways = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                         if p == Shard(d))
        if sizes[0] % ways:
            x = x.redistribute(mesh, [Replicate() if p == Shard(d) else p
                                      for p in x.placements])
    return x.unflatten(dim, sizes)


class _MergeHeads(torch.autograd.Function):
    """x.flatten(-2) whose backward splits the gradient with `unflatten`,
    where autograd's own view backward cannot split a shard."""

    @staticmethod
    def forward(ctx, x):
        ctx.sizes = tuple(x.shape[-2:])
        return x.flatten(-2)

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, -1, ctx.sizes)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) -> (..., H * hd). On a DTensor, the gradient that comes
    back sharded over H * hd (from a heads_x_hd-sharded output projection)
    is split into heads through `unflatten`, replicated first where the
    shards do not hold whole heads (40 heads on 16 devices)."""
    if isinstance(x, DTensor):
        return _MergeHeads.apply(x)
    return x.flatten(-2)


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids], the rows of a (V, D) table. A DTensor table is looked up
    vocab-parallel on each rank's local shards, as GSPMD does it: where the
    table's vocab is sharded (and ids are whole), each rank takes the rows
    it holds and zeros for the rest, and the output is their sum across
    the dim (Partial); ids keep their own shards and the table's other dims
    are gathered. The table's gradient stays sharded by vocab and sums over
    ids' shards."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    ids = as_dtensor(ids, mesh)
    pt, pi, out, gt = [], [], [], []
    for a, b in zip(table.placements, ids.placements):
        b = b if isinstance(b, Shard) else Replicate()
        a = a if a == Shard(0) and b == Replicate() else Replicate()
        pt.append(a)
        pi.append(b)
        out.append(Partial() if a == Shard(0) else b)
        gt.append(a if a == Shard(0) else
                  Partial() if isinstance(b, Shard) else Replicate())
    shape, offset = compute_local_shape_and_global_offset(table.shape, mesh,
                                                          pt)
    v0, vn = offset[0], shape[0]

    def local(t, i):
        j = i - v0
        hit = (j >= 0) & (j < vn)
        return t[j.clamp(0, vn - 1)] * hit[..., None].to(t.dtype)
    return local_map(local, out_placements=out, in_placements=(pt, pi),
                     in_grad_placements=(gt, pi), device_mesh=mesh,
                     redistribute_inputs=True)(table, ids)
