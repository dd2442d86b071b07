"""Attention dispatch on the tensor's device.

A CUDA tensor goes to the hand-written kernel, and the call raises if the
kernel cannot build or launch; a CPU tensor goes to the plain PyTorch
version. There is no other choice: no `impl` argument, and no fallback from
the card to the plain version.

A DTensor (the sharded path, `distributed/sharding.py`) reaches the same
choice through `on_local_shards`: q, k and v are first redistributed so that
only batch and heads stay sharded (attention reduces over keys, so a sharded
key or sequence dim is gathered first: under `serve_rules` the decode cache's
`cache_seq` on `model`), and a per-row length follows the batch. The local
tensors then take the route of their device, through `local_map`. A tensor
on the meta device (the dry-run, `launch/dryrun.py`) runs the plain version:
it allocates nothing there and computes only shapes, and a FLOP counter
counts its products over every (query, key) pair of the score matrix, as
the reference's dry-run counts the naive or blocked attention it lowers.

Counterpart of src/repro/kernels/ops.py. `counts()` and `reset_counts()`
read and clear the kernels' launch counters and the plain versions' call
counters, so a run can show which path it went through.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import as_dtensor
from repro_torch.kernels import counts as _counts
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attn import (flash_decode_attention,
                                             flash_verify_attention)
from repro_torch.kernels.flash_prefill import flash_prefill_attention


def _route(x: torch.Tensor) -> str:
    if x.device.type in ("cuda", "cpu", "meta"):
        return x.device.type
    raise ValueError(f"no attention path for device {x.device}")


def _local_layout(q: DTensor, k: DTensor, q_heads: int):
    """How attention runs on local shards: per mesh dim, the placements of
    q (its heads at dim `q_heads`) and of k/v (B, T, K, hd), the placements
    k's and v's gradients take, and the [lo, hi) of k's heads this rank
    needs (None: all it holds). Batch stays sharded where q or k shards it
    and heads where both do; every other dim (sequence, keys, head_dim) is
    gathered. Where only q shards its heads (K does not divide over the
    mesh dim, e.g. 8 KV heads on 16 devices) q keeps them, k is gathered,
    and each rank takes the KV heads of its own query heads; each rank's
    dk, dv then hold its heads' share, summed across the dim (Partial)."""
    pq: List[Placement] = []
    pk: List[Placement] = []
    for a, b in zip(q.placements, k.placements):
        if Shard(0) in (a, b):
            pq.append(Shard(0))
            pk.append(Shard(0))
        elif a == Shard(q_heads):
            pq.append(a)
            pk.append(b if b == Shard(2) else Replicate())
        else:
            pq.append(Replicate())
            pk.append(Replicate())
    only_q = [a == Shard(q_heads) and b != Shard(2) for a, b in zip(pq, pk)]
    if not any(only_q):
        return pq, pk, pk, None
    H, K = q.shape[q_heads], k.shape[2]
    group = H // K
    shape, offset = compute_local_shape_and_global_offset(
        q.shape, q.device_mesh, pq)
    h0, hn = offset[q_heads], shape[q_heads]
    if Shard(2) in pk or (group % hn and hn % group):
        # the local query heads do not map onto whole local KV heads
        pq = [Replicate() if o else p for p, o in zip(pq, only_q)]
        return pq, pk, pk, None
    grad = [Partial() if o else p for p, o in zip(pk, only_q)]
    return pq, pk, grad, (h0 // group, (h0 + hn - 1) // group + 1)


def on_local_shards(fn: Callable, q, k, v, *rows, q_heads: int = 2):
    """fn(q, k, v, *rows) on each rank's local shards when q is a DTensor,
    else fn as it is. q's heads are its dim `q_heads` (2 for (B, S, H, hd),
    1 for a decode step's (B, H, hd)); k, v are (B, T, K, hd). Each of
    `rows` is None, an int or a per-row (B,) tensor (a length or an
    offset): a tensor follows the batch's sharding. Returns a DTensor with
    q's local placements (`_local_layout`). Differentiable: `local_map`
    redistributes in the backward too."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, *rows)
    mesh = q.device_mesh
    k, v = as_dtensor(k, mesh), as_dtensor(v, mesh)
    pq, pk, pgrad, heads = _local_layout(q, k, q_heads)
    prow = [Shard(0) if p == Shard(0) else Replicate() for p in pq]
    args, in_place = [], []
    for r in rows:
        if isinstance(r, torch.Tensor) and r.dim() == 1:
            args.append(as_dtensor(r, mesh))
            in_place.append(prow)
        else:
            args.append(r)
            in_place.append(None)
    local = fn
    if heads is not None:
        lo, hi = heads

        def local(q, k, v, *rows):
            return fn(q, k[:, :, lo:hi], v[:, :, lo:hi], *rows)
    return local_map(local, out_placements=pq,
                     in_placements=(pq, pk, pk, *in_place),
                     in_grad_placements=(pq, pgrad, pgrad, *in_place),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v, *args)


def _prefill(q, k, v, q_offset, kv_len, *, causal, local_window, out=None):
    if _route(q) == "cuda":
        return flash_prefill_attention(q, k, v, q_offset, kv_len,
                                       causal=causal,
                                       local_window=local_window, out=out)
    o = ref.chunked_prefill_attention_ref(
        q, k, v, q_offset=q_offset, kv_len=kv_len, causal=causal,
        local_window=local_window)
    return o if out is None else out.copy_(o)


def prefill_attention(q, k, v, *, q_offset=0, kv_len=None, causal=True,
                      local_window=0, out=None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,T,K,hd) -> (B,Sq,H,hd), written into `out`
    where given (plain tensors only: no DTensor)."""
    fn = functools.partial(_prefill, causal=causal, local_window=local_window)
    if out is not None:
        return fn(q, k, v, q_offset, kv_len, out=out)
    return on_local_shards(fn, q, k, v, q_offset, kv_len)


def _decode(q, k, v, kv_len):
    if _route(q) == "cuda":
        return flash_decode_attention(q, k, v, kv_len)
    return ref.decode_attention_ref(q, k, v, kv_len=kv_len)


def decode_attention(q, k, v, kv_len) -> torch.Tensor:
    """q: (B,H,hd); k/v: (B,T,K,hd); kv_len int or (B,) -> (B,H,hd)."""
    return on_local_shards(_decode, q, k, v, kv_len, q_heads=1)


def _verify(q, k, v, kv_len):
    if _route(q) == "cuda":
        return flash_verify_attention(q, k, v, kv_len)
    return ref.verify_attention_ref(q, k, v, kv_len)


def verify_attention(q, k, v, kv_len) -> torch.Tensor:
    """q: (B,S,H,hd) at positions kv_len[b] + s; k/v: (B,T,K,hd) with the
    draft K/V written; kv_len int or (B,) -> (B,S,H,hd)."""
    return on_local_shards(_verify, q, k, v, kv_len)


# flash_prefill_wgmma counts the launches of flash_prefill_attention that
# ran its tensor-core body (bf16 at head_dim 64 or 128); the grouped expert
# kernel's counters are read by `kernels.moe_grouped.counts()`
_COUNTED = ("flash_prefill_attention", "flash_prefill_wgmma",
            "flash_decode_attention", "flash_verify_attention",
            "chunked_prefill_attention_ref", "decode_attention_ref",
            "verify_attention_ref")


def counts() -> Dict[str, int]:
    """Kernel launches and plain-version calls since the last reset."""
    return _counts.read(_COUNTED)


def reset_counts() -> None:
    """Clear every counter of `kernels.counts`, the grouped expert
    kernel's too."""
    _counts.reset()
