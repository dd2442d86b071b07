"""The prefill step's share of the card's bf16 peak, in %: model FLOPs of
the prompts served in the window (the architecture's `model_flops`, for a
decoder the matrices each token touches, only its k routed experts, causal
attention, the LM head at the last position) over the time the instance
had work (the union of every request's [arrival, first token]) times
989 TFLOP/s."""
import math

from harness import stats


def read(run):
    flops = sum(run.arch.model_flops(n, run.cfg, run.config)
                for n, t in zip(run.n, run.ttft) if math.isfinite(t))
    busy = stats.length(run.busy)
    if flops == 0 or busy <= 0:
        return None
    return 100.0 * flops / (busy * stats.PEAK_BF16_OPS)
