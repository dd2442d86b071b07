"""The prefill step's share of the card's bf16 peak, in %: model FLOPs of
the prompts served in the window (stats.model_flops: the matrices each token
touches, only its k routed experts, causal attention, the LM head at the
last position) over the time the instance had work (the union of every
request's [arrival, first token]) times 989 TFLOP/s."""
import math

from harness import stats


def read(run):
    c = run.cfg
    flops = sum(stats.model_flops(
        n, layers=c.num_layers, d=c.d_model, H=c.num_heads,
        K=c.num_kv_heads, hd=c.resolved_head_dim, d_ff=c.d_ff,
        vocab=c.vocab_size, experts=c.num_experts,
        top_k=c.experts_per_token)
        for n, t in zip(run.n, run.ttft) if math.isfinite(t))
    busy = stats.length(run.busy)
    if flops == 0 or busy <= 0:
        return None
    return 100.0 * flops / (busy * stats.PEAK_BF16_OPS)
