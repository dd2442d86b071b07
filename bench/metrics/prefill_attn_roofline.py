"""The prefill-attention kernel's share of its roofline, in %: the least
time its launches for the prompts served in the window need (per chunk of
`chunk` tokens and layer, operations over 989 TFLOP/s or bytes over
3.35 TB/s, the larger; what the inputs need, not the padded batch) over the
device time of the kernel's launches in the traced window and its drain."""
import math
import re

from harness import stats

# the bodies of kernels/csrc/flash_prefill.cu, as the profiler names them
# ("void (anonymous namespace)::tc::prefill_tc_kernel<128>(...)")
KERNELS = re.compile(r"\bprefill_(tc_|mma_)?kernel\b")


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.device_time(KERNELS)
    if spent <= 0:
        return None
    c = run.cfg
    bound = sum(stats.prompt_attention_bound(
        n, run.chunk, c.num_layers, c.num_heads, c.num_kv_heads,
        c.resolved_head_dim, run.es)
        for n, t in zip(run.n, run.ttft) if math.isfinite(t))
    return 100.0 * bound / spent
