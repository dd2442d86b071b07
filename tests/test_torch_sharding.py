"""The port's logical-axis sharding (`repro_torch.distributed.sharding`)
against the reference's (`repro.distributed.sharding`), in-process and with
no process group: the reference's `spec_for` reads only `mesh.shape`, so a
stand-in with a `shape` dict replaces a JAX mesh.

For every arch of `ARCH_IDS` (published and tiny configs), under
`train_rules` and `serve_rules`, on the production meshes (16x16, 2x16x16)
and the debug ones (2x2, 2x2x2): the port's PartitionSpec entries and its
DTensor placements for every parameter, cache and AdamW-state leaf equal
the reference's `spec_for` and that spec converted here to placements.
Then the rules' corners: the divisibility and used-axis fallbacks, the
major-to-minor order of a multi-axis entry (each device's block from
DTensor's offsets against the block JAX gives it), and `logical` as the
identity outside a mesh.

    PYTHONPATH=src python -m pytest tests/test_torch_sharding.py -q
"""
import itertools
import math

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jax_config
from repro.configs.base import get_tiny_config as jax_tiny_config
from repro.distributed import sharding as ref
from repro.models import model as RM
from repro.training.optimizer import opt_state_axes as ref_opt_axes
from repro_torch.configs.base import get_config, get_tiny_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as M
from repro_torch.training.optimizer import opt_state_axes

MESHES = {                      # name: ({axis: size} in mesh-dim order, pods)
    "16x16": ({"data": 16, "model": 16}, False),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16}, True),
    "2x2": ({"data": 2, "model": 2}, False),
    "2x2x2": ({"pod": 2, "data": 2, "model": 2}, True),
}


class StandIn:
    """What the reference's `spec_for` reads of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)


def to_placements(spec, sizes):
    """A reference PartitionSpec as DTensor placements, written out here
    independently of the port: Shard(d) on every mesh dim that tensor dim
    d's entry names."""
    out = [Replicate()] * len(sizes)
    names = list(sizes)
    for d, entry in enumerate(spec):
        for axis in (entry,) if isinstance(entry, str) else entry or ():
            out[names.index(axis)] = Shard(d)
    return out


def leaves(axes, shapes, prefix=""):
    """(path, dims, shape) of every leaf of matching nested dicts."""
    for k in sorted(axes):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(axes[k], dict):
            yield from leaves(axes[k], shapes[k], path)
        else:
            yield path, axes[k], tuple(shapes[k])


def check_leaf(path, dims, shape, sizes, rules, jrules):
    want = tuple(ref.spec_for(shape, dims, StandIn(sizes), jrules))
    got = shd.spec_for(shape, dims, sizes, rules)
    assert got == want, (path, shape, dims, got, want)
    assert shd.placements(shape, dims, sizes, rules) == \
        to_placements(want, sizes), (path, shape, dims)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_match_reference_spec_for(arch, mesh):
    sizes, pods = MESHES[mesh]
    n = 0
    for tiny in (False, True):
        cfg = (get_tiny_config if tiny else get_config)(arch)
        jcfg = (jax_tiny_config if tiny else jax_config)(arch)
        axes, shapes = M.param_axes(cfg), M.model_shapes(cfg)
        assert axes == RM.param_axes(jcfg)
        c_axes = M.cache_axes(cfg)
        j_axes = RM.cache_axes(jcfg)
        assert j_axes.pop("pos") == () and c_axes == j_axes
        c_shapes = {k: s for k, (s, _) in
                    M.cache_shapes(cfg, 128, 32768).items()}
        o_axes = opt_state_axes(axes)
        j_opt = ref_opt_axes(RM.param_axes(jcfg))
        for kind in ("train", "serve"):
            rules = getattr(shd, f"{kind}_rules")(multi_pod=pods)
            jrules = getattr(ref, f"{kind}_rules")(multi_pod=pods)
            assert rules.rules == jrules.rules
            for path, dims, shape in leaves(axes, shapes):
                check_leaf(path, dims, shape, sizes, rules, jrules)
                n += 1
            for path, dims, shape in leaves(c_axes, c_shapes):
                check_leaf(path, dims, shape, sizes, rules, jrules)
                n += 1
            for path, dims, shape in leaves(axes, shapes):   # AdamW m, v
                node_m, node_v = j_opt.m, j_opt.v
                for part in path.split("/"):
                    node_m, node_v = node_m[part], node_v[part]
                assert o_axes.m[path] == node_m == o_axes.v[path] == node_v
                check_leaf(path, o_axes.m[path], shape, sizes, rules, jrules)
            assert o_axes.step == j_opt.step == ()
            # the port's tree form gives the same placements leaf for leaf
            tree = shd.tree_placements(axes, shapes, sizes, rules)
            for path, dims, shape in leaves(axes, shapes):
                node = tree
                for part in path.split("/"):
                    node = node[part]
                assert node == shd.placements(shape, dims, sizes, rules)
    assert n > 0


def test_divisibility_fallback_replicates():
    sizes = {"data": 16, "model": 16}
    rules = shd.serve_rules()
    # 8 KV heads on a 16-way model axis: replicated, as the reference does
    dims = ("cache_batch", None, "kv_heads", None)
    assert shd.spec_for((32, 4, 8, 128), dims, sizes, rules) == \
        ("data", None, None, None)
    assert shd.placements((32, 4, 8, 128), dims, sizes, rules) == \
        [Shard(0), Replicate()]
    # a batch of 4 on 16-way data: replicated too
    assert shd.placements((4, 4, 32, 128), dims, sizes, rules) == \
        [Replicate(), Shard(2)]


def test_used_axis_fallback_drops_a_repeated_axis():
    sizes = {"data": 2, "model": 2}
    rules = shd.train_rules()
    # RG-LRU's (lru, lru) square: the second dim may not reuse `model`
    assert shd.spec_for((64, 64), ("lru", "lru"), sizes, rules) == \
        ("model", None)
    assert shd.placements((64, 64), ("lru", "lru"), sizes, rules) == \
        [Replicate(), Shard(0)]
    jr = ref.train_rules()
    assert tuple(ref.spec_for((64, 64), ("lru", "lru"), StandIn(sizes),
                              jr)) == ("model", None)


def jax_block(entry, sizes, coord, dim):
    """The [offset, offset + size) JAX gives the device at `coord` along a
    dim of length `dim` sharded by a PartitionSpec entry: major to minor in
    the entry's order."""
    names = list(sizes)
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    index = 0
    for a in axes:
        index = index * sizes[a] + coord[names.index(a)]
    block = dim // math.prod(sizes[a] for a in axes)
    return index * block, block


@pytest.mark.parametrize("mesh", ["2x2x2", "2x16x16"])
def test_multi_axis_entry_blocks_match_jax_order(mesh):
    """act_batch is ("pod", "data") under multi-pod rules: each device's
    block of the batch, from DTensor's offsets, is the one JAX gives it."""
    sizes, _ = MESHES[mesh]
    rules = shd.train_rules(multi_pod=True)
    shape, dims = (64, 16, 32), ("act_batch", None, "act_heads")
    spec = shd.spec_for(shape, dims, sizes, rules)
    assert spec == (("pod", "data"), None, "model")
    place = shd.placements(shape, dims, sizes, rules)
    for coord in itertools.product(*(range(n) for n in sizes.values())):
        local, offset = _compute_local_shape_and_global_offset(
            shape, tuple(sizes.values()), list(coord), place)
        for d, entry in enumerate(spec):
            want = (0, shape[d]) if entry is None else \
                jax_block(entry, sizes, coord, shape[d])
            assert (offset[d], local[d]) == want, (coord, d)


def test_an_entry_out_of_mesh_order_raises():
    rules = shd.ShardingRules({"b": ("data", "pod")})
    with pytest.raises(ValueError, match="mesh-dim order"):
        shd.placements((8,), ("b",), {"pod": 2, "data": 2}, rules)


def test_logical_is_the_identity_outside_a_mesh():
    x = torch.randn(2, 3, 4)
    assert shd.current() is None
    assert shd.logical(x, "act_batch", "act_seq", "act_d") is x
    with shd.use_sharding(None, shd.train_rules()):
        assert shd.current() is None
        assert shd.logical(x, "act_batch", "act_seq", "act_d") is x
