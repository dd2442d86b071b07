"""Model parameters as an `nn.Module`, built from the JAX reference's
`init_params` pytree or drawn from a seeded `torch.Generator`.

The module keeps the reference's key names and layout: ``embed``,
``final_norm``, ``unembed`` and a stacked ``layers`` group (``{ln1, wq, wk,
wv, wo, ln2, wi, wd}``, ``router`` in an MoE stack, the Mamba2 leaves for
ssm, the LayerNorm biases, GELU MLP and ``*_x`` cross-attention leaves of
Whisper's decoder beside its ``enc_layers``), or the nested groups
``pairs.{dense, moe}`` of interleaved MoE pairs and ``blocks.{r1, r2,
attn}`` and ``tail`` of the recurrent hybrid, each leaf stacked with a
leading layer axis, so ``params["blocks"]["r1"]["w_x"]`` reads as it does
in src/repro/models/model.py.

Serving's parameters are frozen (the default): `forward`, `prefill` and the
decode steps then build no autograd graph. Training asks for trainable
ones (``trainable=True`` in `init_params`, `from_jax_params` or
`ModelParams`), and `ModelParams.leaves` gives every leaf under the
reference's key path (``layers/wq``, ``blocks/r1/w_x``) in the order of the
reference pytree's leaves, which the optimizer and the checkpoints use.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import model_shapes, param_axes


def _group(tree: Mapping[str, Any], trainable: bool) -> nn.Module:
    """A group of leaves as an `nn.ParameterDict`, a group of groups as an
    `nn.ModuleDict` of them."""
    if any(isinstance(v, Mapping) for v in tree.values()):
        return nn.ModuleDict({k: _group(v, trainable)
                              for k, v in tree.items()})
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=trainable)
                             for k, t in tree.items()})


class ModelParams(nn.Module):
    """Stacked parameters of one model of a ported family; `params[key]`
    (and `params[group][sub][key]`) mirrors the reference pytree's dict
    access. Frozen unless `trainable`."""

    def __init__(self, tree: Mapping[str, Any], *, trainable: bool = False):
        super().__init__()
        for key, val in tree.items():
            setattr(self, key, _group(val, trainable)
                    if isinstance(val, Mapping)
                    else nn.Parameter(val, requires_grad=trainable))

    def leaves(self) -> Dict[str, nn.Parameter]:
        """{key path: leaf}, paths `/`-joined as the reference's checkpoint
        keys are (``layers/wq``), in the order of the reference pytree's
        leaves: keys sorted at every level, as JAX flattens a dict."""
        named = {name.replace(".", "/"): t
                 for name, t in self.named_parameters()}
        return {path: named[path] for path in sorted(
            named, key=lambda path: path.split("/"))}

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype


def from_jax_params(np_tree: Mapping[str, Any], *, device="cuda",
                    dtype: torch.dtype = torch.float32,
                    trainable: bool = False) -> ModelParams:
    """The reference's `init_params` pytree, with leaves already converted to
    numpy arrays by the caller, as a `ModelParams` on `device` in `dtype`."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)

    return ModelParams(conv(np_tree), trainable=trainable)


def nested(leaves: Mapping[str, Any]) -> Dict[str, Any]:
    """{key path: leaf} (``layers/wq``, as `ModelParams.leaves` gives it)
    as nested dicts."""
    tree: Dict[str, Any] = {}
    for path, t in leaves.items():
        *groups, name = path.split("/")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[name] = t
    return tree


def distribute_params(params: ModelParams, cfg: ModelConfig, mesh,
                      rules: "shd.ShardingRules") -> ModelParams:
    """The same weights as DTensors on `mesh`, each leaf placed by its
    logical dims (`param_axes`) under `rules`: each rank keeps its own
    block, and nothing is communicated. Trainable when `params` is."""
    tree = nested({k: t.detach() for k, t in params.leaves().items()})
    trainable = any(t.requires_grad for t in params.leaves().values())
    return ModelParams(shd.distribute_tree(tree, param_axes(cfg), mesh,
                                           rules), trainable=trainable)


# a slice of a stacked leaf above this many elements is drawn in parts
_DRAW_ELEMENTS = 2 ** 30


def _fan_in(shape) -> int:
    """The reference's rule: the second-to-last axis (D for an expert's
    (.., E, D, 2F) gate|up and the (.., D, E) router, F for (.., E, F, D)),
    or d for the dense (.., d, 2, F) gate|up."""
    if len(shape) >= 3 and shape[-2] == 2:       # (.., d, 2, F) gate|up
        return shape[-3]
    if len(shape) >= 2:
        return shape[-2]
    return shape[-1]


def _fix_recurrent(group: dict) -> None:
    """The reference's family inits: Mamba2's A_log = log(1..nh), dt_bias
    0.5 and Dp 1; RG-LRU's a_param 0.7."""
    if "A_log" in group:
        a = group["A_log"]
        nh = a.shape[-1]
        a.copy_(torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                       device=a.device)).expand(a.shape))
        group["dt_bias"].fill_(0.5)
        group["Dp"].fill_(1.0)
    if "a_param" in group:
        group["a_param"].fill_(0.7)


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda", dtype: torch.dtype = torch.float32,
                trainable: bool = False) -> ModelParams:
    """Random weights with the reference's shapes and fan-in scaling
    (src/repro/models/model.py `init_params`): N(0, 1/fan_in) matrices and
    zero vectors (norm weights scale by 1 + w), then its ssm and RG-LRU
    inits. Drawn in f32 from `generator`, which must live on `device`;
    stacked leaves are drawn one layer at a time so a full-width model needs
    no f32 copy of itself, and a layer slice above _DRAW_ELEMENTS (one
    Llama4-Maverick MoE layer's experts, 10.7 G elements) one expert at a
    time."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} but device {dev}")

    def fill(x: torch.Tensor, scale: float, whole: bool) -> None:
        if x.dim() >= 3 and (whole or x.numel() > _DRAW_ELEMENTS):
            for part in x:
                fill(part, scale, False)
            return
        x.copy_(torch.randn(x.shape, generator=generator, device=dev,
                            dtype=torch.float32).mul_(scale))

    def draw(shape) -> torch.Tensor:
        if len(shape) == 1 or shape[-1] == 1:
            return torch.zeros(shape, dtype=dtype, device=dev)
        out = torch.empty(shape, dtype=dtype, device=dev)
        fill(out, 1.0 / math.sqrt(max(_fan_in(shape), 1)), True)
        return out

    def make(shapes):
        if isinstance(shapes, dict):
            group = {k: make(s) for k, s in shapes.items()}
            _fix_recurrent(group)
            return group
        return draw(shapes)

    return ModelParams(make(model_shapes(cfg)), trainable=trainable)


def redraw_norms(params: ModelParams, seed: int) -> ModelParams:
    """Redraw, in place, every LayerNorm weight (a leaf with a `<key>_b`
    sibling) as 1 + 0.1 N(0,1) and every bias as 0.1 N(0,1), from a
    generator seeded `seed` on the weights' device. `init_params` keeps the
    reference's zero vectors, and the reference's LayerNorm scales by w (not
    1 + w): a Whisper drawn that way outputs exactly zero, so a check that
    must see it compute something redraws these first."""
    gen = torch.Generator(device=params.device).manual_seed(seed)
    leaves = dict(params.named_parameters())
    for name, t in leaves.items():
        key = name.rsplit(".", 1)[-1]
        if name + "_b" in leaves:
            base = 1.0
        elif key.endswith("_b") or key in ("bi", "bd", "bq", "bk", "bv"):
            base = 0.0
        else:
            continue
        with torch.no_grad():                   # trainable leaves too
            t.copy_(base + 0.1 * torch.randn(t.shape, generator=gen,
                                             device=t.device))
    return params
