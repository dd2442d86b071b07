"""The port's simulator and traces (`repro_torch.sim`, `repro_torch.traces`,
verbatim copies of the reference's) and its H100 `HardwareSpec`
(`repro_torch.sim.hardware`). `resolve_hardware` takes the instance as it
is; the cost model prices Llama3-8B's prefill below the A100's on it; and a
`ClusterSim` run over each stress scenario, on the A800 and on the H100,
gives identical results through `repro.sim` and `repro_torch.sim`. The
reference's tests/test_sim.py, test_cluster.py, test_hetero_cluster.py,
test_costmodel_vec.py and test_traces.py hold the same code, which
tests/test_torch_isolation.py pins to the copies.

    PYTHONPATH=src python -m pytest tests/test_torch_sim.py -q
"""
import dataclasses

import pytest

from repro.sim import costmodel as ref_cost
from repro.sim.cluster import simulate_cluster as ref_simulate_cluster
from repro.traces.qwentrace import TraceConfig as RefTraceConfig
from repro.traces.qwentrace import generate as ref_generate
from repro.traces.scenarios import scenario_names
from repro_torch.sim import costmodel
from repro_torch.sim.cluster import simulate_cluster
from repro_torch.sim.hardware import H100
from repro_torch.traces.qwentrace import TraceConfig, generate


def test_resolve_hardware_takes_the_h100_as_it_is():
    assert costmodel.resolve_hardware(H100) is H100
    assert (H100.name, H100.peak_flops, H100.hbm_bw) == \
        ("H100-SXM5-80G", 989e12, 3.35e12)
    defaults = costmodel.HardwareSpec("x", 1.0, 1.0)
    for f in dataclasses.fields(H100):          # every other field default
        if f.name not in ("name", "peak_flops", "hbm_bw"):
            assert getattr(H100, f.name) == getattr(defaults, f.name)


@pytest.mark.parametrize("n", [256, 2048, 8192, 32768])
def test_h100_prices_llama3_8b_below_the_a100(n):
    h100 = costmodel.PrefillCostModel(costmodel.LLAMA3_8B, H100)
    a100 = costmodel.PrefillCostModel(costmodel.LLAMA3_8B, costmodel.A100)
    assert 0 < h100.prefill_time(n) < a100.prefill_time(n)


def _ref_h100():
    """The same spec built from the reference's own dataclass."""
    return ref_cost.HardwareSpec(H100.name, peak_flops=H100.peak_flops,
                                 hbm_bw=H100.hbm_bw)


@pytest.mark.parametrize("hw", ["a800", "h100"])
@pytest.mark.parametrize("scenario", scenario_names())
def test_cluster_sim_equals_the_reference(scenario, hw):
    kw = dict(rate=4, duration=20, seed=0, scenario=scenario)
    mine = generate(TraceConfig(**kw))
    theirs = ref_generate(RefTraceConfig(**kw))
    assert [(r.arrival, r.num_tokens) for r in mine] == \
        [(r.arrival, r.num_tokens) for r in theirs]
    sim = dict(num_instances=2, dispatch="least-loaded", decode_instances=1)
    got = simulate_cluster("flowprefill", mine,
                           hw=H100 if hw == "h100" else hw, **sim)
    want = ref_simulate_cluster(
        "flowprefill", theirs,
        hw=_ref_h100() if hw == "h100" else hw, **sim)
    for key in ("attainment", "rounds", "preemptions", "makespan",
                "dispatched", "decoded", "tbt_attainment", "blocking_times"):
        assert getattr(got, key) == getattr(want, key), key
    assert [(r.ttft, r.first_token_time) for r in got.requests] == \
        [(r.ttft, r.first_token_time) for r in want.requests]
