"""Baseline system presets for the simulator (paper §6.1 Baselines)."""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.request import Request
from repro_torch.sim.costmodel import (MODEL_SPECS, MODEL_TP, A800, HardwareSpec,
                                 PrefillCostModel)
from repro_torch.sim.simulator import PrefillSim, SimConfig, SimResult


def preset(name: str, **overrides) -> SimConfig:
    presets = {
        # DistServe default: FCFS, run-to-completion, no SLO awareness
        "distserve": SimConfig(policy="fcfs", granularity="whole",
                               preempt=False, enable_batching=False),
        # DistServe + Chunked Prefill + EDF (chunk-boundary preemption;
        # scheduling decision at every chunk boundary; vLLM-style greedy
        # token-budget batching up to the chunk size)
        "distserve-cp2k": SimConfig(policy="edf", granularity="chunk",
                                    chunk_tokens=2048, enable_batching=True,
                                    batching_mode="greedy", batch_budget=2048,
                                    check_overhead=200e-6),
        "distserve-cp8k": SimConfig(policy="edf", granularity="chunk",
                                    chunk_tokens=8192, enable_batching=True,
                                    batching_mode="greedy", batch_budget=8192,
                                    check_overhead=200e-6),
        # layer-level scheduling (Laser/Layered-Prefill style): preemption at
        # layer boundaries, scheduling check polled at every boundary
        "layer-level": SimConfig(policy="edf", granularity="layer",
                                 enable_batching=False,
                                 check_overhead=200e-6),
        # FlowPrefill: operator boundaries, event-driven (no polling cost),
        # S-EDF + SLO-aware batching
        "flowprefill": SimConfig(policy="s-edf", granularity="op",
                                 enable_batching=True, batch_budget=4096),
        # ablations
        "flowprefill-edf": SimConfig(policy="edf", granularity="op",
                                     enable_batching=True, batch_budget=4096),
        "flowprefill-dedf": SimConfig(policy="d-edf", granularity="op",
                                      enable_batching=True, batch_budget=4096),
        "flowprefill-nobatch": SimConfig(policy="s-edf", granularity="op",
                                         enable_batching=False),
    }
    cfg = presets[name]
    if overrides:
        from dataclasses import replace
        cfg = replace(cfg, **overrides)
    return cfg


def simulate(system: str, requests: Sequence[Request], model: str = "llama3-8b",
             hw: HardwareSpec = A800, **overrides) -> SimResult:
    spec = MODEL_SPECS[model]
    from dataclasses import replace as _r
    spec = _r(spec, tp=MODEL_TP.get(model, 1))
    cost = PrefillCostModel(spec, hw)
    sim = PrefillSim(cost, preset(system, **overrides))
    # simulate on fresh copies so sweeps don't share Request state
    import copy
    reqs = [copy.copy(r) for r in requests]
    return sim.run(reqs)
