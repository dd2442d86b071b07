"""Chunked-causal flash attention: the `attn` operator of every prefill
segment, as a CUDA kernel for Hopper (`csrc/flash_prefill.cu`, whose header
note says what bounds it and how it is laid out).

Counterpart of `flash_prefill_attention` in src/repro/kernels/flash_prefill.py.
`q_offset` and `kv_len` are plain runtime integers: no chunk position and no
resume after a preemption rebuilds or respecialises the kernel. The plain
version is `kernels.ref.chunked_prefill_attention_ref`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, counts

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_attention
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L,
                   _I, _I, _I, _I, ctypes.c_float, _P]
    fn.restype = _I
    return lib, fn


def check_operand(name: str, x: torch.Tensor, device, dtype, hd: int) -> None:
    """Raise unless `x` is a CUDA tensor of the kernel's type whose last two
    axes (heads, head_dim) are dense and whose strides and address allow the
    kernel's 4-element vector accesses."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, "
                         f"got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype} differs from q's {dtype}")
    if x.stride(-1) != 1 or x.stride(-2) != hd:
        raise ValueError(f"{name}: the (heads, head_dim) axes must be dense, "
                         f"got strides {x.stride()}")
    if any(s % 4 for s in x.stride()[:-2]) or \
            x.data_ptr() % (4 * x.element_size()):
        raise ValueError(f"{name}: strides {x.stride()} or address not "
                         "aligned to 4 elements")


def flash_prefill_attention(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, T, K, hd)
    v: torch.Tensor,            # (B, T, K, hd)
    q_offset: int = 0,
    kv_len: int | None = None,
    *,
    causal: bool = True,
    local_window: int = 0,
) -> torch.Tensor:
    """Chunked-causal flash attention on the card. Returns (B, Sq, H, hd) in
    q's dtype; rows with no visible key are 0."""
    B, Sq, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_prefill_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_prefill_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"flash_prefill_attention: H={H} not a multiple "
                         f"of K={K}")
    if tuple(k.shape) != (B, T, K, hd) or v.shape != k.shape:
        raise ValueError(f"flash_prefill_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, q.device, q.dtype, hd)
    kv_len = T if kv_len is None else int(kv_len)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], B, Sq, T, H, K, hd,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), out.stride(0), out.stride(1),
             int(q_offset), kv_len, int(bool(causal)), int(local_window),
             1.0 / math.sqrt(hd), stream)
    build.check(lib, err, "flash_prefill_attention")
    counts.bump("flash_prefill_attention")
    return out
