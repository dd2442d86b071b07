"""Model parameters as an `nn.Module`, built from the JAX reference's
`init_params` pytree or drawn from a seeded `torch.Generator`.

The module keeps the reference's key names and layout: ``embed``,
``final_norm``, ``unembed`` and ``layers.{ln1, wq, wk, wv, wo, ln2, wi, wd}``,
each layer leaf stacked with a leading L axis, so ``params["layers"]["wq"]``
reads as ``params["layers"]["wq"]`` does in src/repro/models/model.py. The
parameters are frozen: serving never builds an autograd graph.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import model_shapes


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ModelParams(nn.Module):
    """Stacked parameters of one dense model; `params[key]` mirrors the
    reference pytree's dict access."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if key == "layers":
                self.layers = nn.ParameterDict(
                    {k: _frozen(t) for k, t in val.items()})
            elif isinstance(val, Mapping):
                raise NotImplementedError(
                    f"parameter group {key!r}: only the dense family "
                    "(one stacked `layers` group) is ported")
            else:
                setattr(self, key, _frozen(val))

    def __getitem__(self, key: str):
        return getattr(self, key)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype


def from_jax_params(np_tree: Mapping[str, Any], *, device="cuda",
                    dtype: torch.dtype = torch.float32) -> ModelParams:
    """The reference's `init_params` pytree, with leaves already converted to
    numpy arrays by the caller, as a `ModelParams` on `device` in `dtype`."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=dtype)

    return ModelParams(conv(np_tree))


def _fan_in(shape) -> int:
    if len(shape) >= 3 and shape[-2] == 2:       # (.., d, 2, F) gate|up
        return shape[-3]
    if len(shape) >= 2:
        return shape[-2]
    return shape[-1]


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda", dtype: torch.dtype = torch.float32
                ) -> ModelParams:
    """Random weights with the reference's shapes and fan-in scaling
    (src/repro/models/model.py `init_params`): N(0, 1/fan_in) matrices and
    zero vectors (norm weights scale by 1 + w). Drawn in f32 from
    `generator`, which must live on `device`; stacked leaves are drawn one
    layer at a time so a full-width model needs no f32 copy of itself."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} but device {dev}")

    def draw(shape) -> torch.Tensor:
        scale = 1.0 / math.sqrt(max(_fan_in(shape), 1))
        if len(shape) == 1 or shape[-1] == 1:
            return torch.zeros(shape, dtype=dtype, device=dev)
        out = torch.empty(shape, dtype=dtype, device=dev)
        parts = out if len(shape) >= 3 else out[None]
        for part in parts:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev, dtype=torch.float32) * scale)
        return out

    shapes = model_shapes(cfg)
    tree = {k: ({kk: draw(s) for kk, s in v.items()} if isinstance(v, dict)
                else draw(v)) for k, v in shapes.items()}
    return ModelParams(tree)
