"""The prefill-attention kernel's share of its roofline, in %: the least
time its launches for the prompts served in the window need (the
architecture's `prompt_attention_bound`: per chunk of `chunk` tokens and
layer, operations over 989 TFLOP/s or bytes over 3.35 TB/s, the larger;
what the inputs need, not the padded batch) over the device time of the
launches its `ATTENTION_KERNELS` name in the traced window and its drain."""
import math


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.device_time(run.arch.ATTENTION_KERNELS)
    if spent <= 0:
        return None
    bound = sum(run.arch.prompt_attention_bound(n, run.chunk, run.cfg,
                                                run.config, run.es)
                for n, t in zip(run.n, run.ttft) if math.isfinite(t))
    return 100.0 * bound / spent
