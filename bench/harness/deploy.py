"""A cell's deployment: the port's `ModelConfig` from the configuration
file (built by its architecture's module, bench/arch/), weights drawn from
the seed on the device, and one prefill and one decode instance behind a
Proxy, wired as `repro_torch.launch.serve.build` wires them.

The weights are the benchmark's: drawn here in the program's layout
(`model_shapes`) and handed to the program and to the plain reference alike.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

import torch

from harness import files

ARCH_DIR = Path(__file__).resolve().parents[1] / "arch"


def model_config(spec: dict, arch=None):
    """The ModelConfig the configuration file describes, built by its
    architecture's module (`arch`, or `bench/arch/<reference>.py` beside
    this harness), which raises where a width differs from the port's
    config of `port_arch`."""
    if arch is None:
        arch = files.arch(ARCH_DIR, spec["reference"])
    return arch.model_config(spec)


def _std(key: str, shape, d_model: int) -> float:
    """Scale of a leaf: 0.1 for vectors (norm offsets, the port scales by
    1 + w, and biases), 1/sqrt(d_model) for the embedding and the
    unembedding, so logits spread over about one unit, and 1/sqrt(fan_in)
    for the other matrices (the second-to-last axis, or d of a (d, 2, F)
    gate|up)."""
    if len(shape) == 1:
        return 0.1
    if key in ("embed", "unembed"):
        return 1.0 / math.sqrt(d_model)
    fan_in = shape[-3] if len(shape) >= 3 and shape[-2] == 2 else shape[-2]
    return 1.0 / math.sqrt(fan_in)


def draw_weights(cfg, seed: int, device, dtype: torch.dtype):
    """Weights in the program's layout, drawn on `device` in `dtype` from a
    generator seeded `seed` there: one normal_ per leaf, or per layer of a
    stacked leaf. Returns the program's ModelParams."""
    from repro_torch.models.model import model_shapes
    from repro_torch.params import ModelParams
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(key, shape, stacked):
        t = torch.empty(shape, dtype=dtype, device=device)
        std = _std(key, shape[1:] if stacked else shape, cfg.d_model)
        for part in (t if stacked else [t]):
            part.normal_(0.0, std, generator=gen)
        return t

    tree = {}
    for key, shape in model_shapes(cfg).items():
        if isinstance(shape, dict):
            tree[key] = {k: make(k, s, True) for k, s in shape.items()}
        else:
            tree[key] = make(key, shape, False)
    return ModelParams(tree)


def plain_weights(params) -> Dict:
    """The same tensors as nested plain dicts, for the reference."""
    out = {}
    for key in ("embed", "final_norm", "unembed"):
        if key in params:
            out[key] = params[key].detach()
    out["layers"] = {k: v.detach() for k, v in params["layers"].items()}
    return out


@dataclass
class Deployment:
    cfg: object
    executor: object
    profile: Dict[int, float]
    prefill: object
    decode: object
    proxy: object

    def shutdown(self) -> None:
        self.proxy.shutdown()


def build(cfg, params, spec: dict, max_seq: int) -> Deployment:
    """`repro_torch.launch.serve.build`'s wiring on these weights: the
    SegmentedPrefill, the offline TTFT profile at 256, 1024 and max_seq
    tokens (which also warms every shape the prefill path runs), the S-EDF
    SchedulerCore with its fitted TTFTPredictor, one PrefillInstance, one
    DecodeInstance taking no decode tokens beyond the prefill's first (the
    KV handoff alone), and the Proxy."""
    from repro_torch.core import SchedulerCore, TTFTPredictor
    from repro_torch.launch.serve import ttft_profile
    from repro_torch.models.segments import SegmentedPrefill
    from repro_torch.serving.decode_instance import DecodeInstance
    from repro_torch.serving.prefill_instance import PrefillInstance
    from repro_torch.serving.proxy import Proxy
    dep = spec["deployment"]
    executor = SegmentedPrefill(params, cfg, max_seq=max_seq,
                                granularity=dep["granularity"],
                                chunk_tokens=dep["chunk_tokens"],
                                cache_dtype=params.dtype)
    profile = ttft_profile(
        executor, sorted({n for n in (256, 1024, max_seq) if n <= max_seq}))
    pred = TTFTPredictor.fit(list(profile), list(profile.values()))
    core = SchedulerCore(predictor=pred, policy=dep["policy"],
                         batch_budget=dep["batch_budget"])
    inst = PrefillInstance(params, cfg, core, max_seq=max_seq,
                           executor=executor,
                           dispatch_depth=dep["dispatch_depth"])
    dec = DecodeInstance(params, cfg, decode_tokens=0, decode_max_batch=1)
    return Deployment(cfg=cfg, executor=executor, profile=profile,
                      prefill=inst, decode=dec, proxy=Proxy([inst], [dec]))
