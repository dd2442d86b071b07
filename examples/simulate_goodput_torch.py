"""Cluster-scale goodput evaluation (paper Fig. 9) via the calibrated
discrete-event simulator: FlowPrefill vs DistServe / DistServe-CP2K / CP8K /
layer-level on the QwenTrace-statistics trace (Llama3-8B on A800).

    PYTHONPATH=src python examples/simulate_goodput_torch.py [--model llama3-8b]

The PyTorch port's counterpart of examples/simulate_goodput.py, on the
port's copies of the simulator and the trace generator
(`repro_torch.sim`, `repro_torch.traces`); it runs on the host only and
prints the same table.
"""
import argparse

from repro_torch.core.metrics import max_goodput
from repro_torch.sim.policies import simulate
from repro_torch.traces.qwentrace import TraceConfig, generate

RATES = [0.25, 0.5, 1, 2, 4, 6, 8, 12, 16]
SYSTEMS = ["distserve", "distserve-cp8k", "distserve-cp2k", "layer-level",
           "flowprefill"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama3-8b")
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    print(f"== goodput sweep ({args.model}, QwenTrace stats) ==")
    print(f"{'system':>16s} | " + " ".join(f"{r:>5}" for r in RATES) +
          " | goodput")
    goodputs = {}
    for system in SYSTEMS:
        atts = []
        for rate in RATES:
            reqs = generate(TraceConfig(rate=rate, duration=args.duration,
                                        seed=args.seed, model=args.model))
            atts.append(simulate(system, reqs, model=args.model).attainment)
        g = max_goodput(RATES, atts)
        goodputs[system] = g
        print(f"{system:>16s} | " +
              " ".join(f"{a:5.2f}" for a in atts) + f" | {g:5.2f} req/s")
    fp = goodputs["flowprefill"]
    print("\nFlowPrefill goodput ratios "
          "(paper: 4.7-5.6x vs DistServe, <=2.0x vs CP2K, <=4.5x vs CP8K):")
    for system in SYSTEMS[:-1]:
        if goodputs[system] > 0:
            print(f"  vs {system:>16s}: {fp/goodputs[system]:.1f}x")


if __name__ == "__main__":
    main()
