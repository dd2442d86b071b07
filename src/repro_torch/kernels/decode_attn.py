"""Flash-decode GQA attention: one new token per row against that row's KV
view with a per-row valid length, as a CUDA kernel for Hopper
(`csrc/decode_attn.cu`, whose header note says what bounds it and how it is
laid out).

Counterpart of `flash_decode_attention` in src/repro/kernels/decode_attn.py.
The speculative-verify kernel of that module (`flash_verify_attention`) is
not ported yet. The plain version is `kernels.ref.decode_attention_ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.flash_prefill import DTYPES, HEAD_DIMS, check_operand

MAX_QG = 16                     # query heads per KV head the kernel holds

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("decode_attn")
    fn = lib.flash_decode_attention
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, ctypes.c_float, _P]
    fn.restype = _I
    return lib, fn


def flash_decode_attention(
    q: torch.Tensor,            # (B, H, hd) — one new token per request
    k: torch.Tensor,            # (B, T, K, hd)
    v: torch.Tensor,            # (B, T, K, hd)
    kv_len,                     # int, or (B,) valid lengths (any device)
) -> torch.Tensor:
    """Flash-decode on the card. Returns (B, H, hd) in q's dtype. A scalar
    `kv_len` broadcasts to every row; rows with kv_len 0 are 0."""
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_decode_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if K == 0 or H % K or H // K > MAX_QG:
        raise ValueError(f"flash_decode_attention: H={H}, K={K} needs H a "
                         f"multiple of K with at most {MAX_QG} query heads "
                         "per KV head")
    if tuple(k.shape) != (B, T, K, hd) or v.shape != k.shape:
        raise ValueError(f"flash_decode_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, q.device, q.dtype, hd)
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    lens = lens.reshape(-1).expand(B).contiguous()
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
             out.data_ptr(), DTYPES[q.dtype], B, T, H, K, hd,
             q.stride(0), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
             out.stride(0), 1.0 / math.sqrt(hd), stream)
    build.check(lib, err, "flash_decode_attention")
    counts.bump("flash_decode_attention")
    return out
