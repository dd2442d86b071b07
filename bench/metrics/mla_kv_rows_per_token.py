"""Latent rows up-projected per query row of latent attention's prefill
(the recompute factor of the chunked up-projection): the sum of the
`kv_rows` of the window's `segment` spans that ran a latent-attention
`attn` (each chunk up-projects every visible latent row, [0, q_offset +
Sc), for its Sc queries) over the sum of their `q_rows`. About the
prompt's chunk count over 2 for a long prompt, 1 for a one-chunk prompt.
None where no span carries `kv_rows` (another architecture, or a program
without the attribute)."""
from harness import spans


def read(run):
    got = spans.of(run)
    if got is None:
        return None
    attn = [s for s in spans.named(got, "segment") if "kv_rows" in s.attrs]
    q_rows = sum(s.attrs["q_rows"] for s in attn)
    return sum(s.attrs["kv_rows"] for s in attn) / q_rows if q_rows else None
