"""Chunked-causal flash attention: the `attn` operator of every prefill
segment, as a CUDA kernel for Hopper (`csrc/flash_prefill.cu`, whose header
note says what bounds it and how it is laid out).

Counterpart of `flash_prefill_attention` in src/repro/kernels/flash_prefill.py.
`q_offset` and `kv_len` are plain runtime integers: no chunk position and no
resume after a preemption rebuilds or respecialises the kernel. The plain
version is `kernels.ref.chunked_prefill_attention_ref`.

The kernel has four bodies, chosen by dtype and head_dim in its C entry
point: bf16 at head_dim 64 or 128 runs on the tensor cores by wgmma (K/V by
TMA, P split into two bf16 terms); bf16 at 256 on the tensor cores by
mma.sync (K/V by cp.async, the same two-term P), where the wgmma body's
tiles do not fit in shared memory; bf16 at q/k width 192 with v width 128
(latent attention's up-projected heads, `MLA_HEAD_DIMS`) on the wgmma body
with the two widths apart (`prefill_mla_kernel`); f32 at every head_dim and
bf16 at 16 or 32 run on the CUDA cores in f32. Every launch counts
`flash_prefill_attention`, a launch of a tensor-core body also
`flash_prefill_wgmma`, and one of the latent-attention body
`flash_prefill_mla`.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, counts

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
# (q/k width, v width) pairs of the latent-attention body, bf16 only
MLA_HEAD_DIMS = ((192, 128),)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_attention
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L,
                   _I, _I, _I, _I, ctypes.c_float, _P, ctypes.POINTER(_I)]
    fn.restype = _I
    return lib, fn


def tensor_core_body(dtype: torch.dtype, hd: int,
                     hd_v: int | None = None) -> bool:
    """Whether a call of this dtype, head_dim and v width (default the
    head_dim) runs a tensor-core body (the C entry point makes the same
    choice and reports it)."""
    if hd_v is not None and hd_v != hd:
        return dtype == torch.bfloat16 and (hd, hd_v) in MLA_HEAD_DIMS
    return dtype == torch.bfloat16 and hd in TENSOR_CORE_HEAD_DIMS


def tma_strides(x: torch.Tensor):
    """(batch, row) strides in elements of a (B, rows, heads, hd) operand as
    its tensor map takes them: an axis of size 1 is never stepped, so it gets
    the dense stride, which TMA accepts."""
    sb, ss = x.stride(0), x.stride(1)
    if x.shape[1] == 1:
        ss = x.shape[2] * x.shape[3]
    if x.shape[0] == 1:
        sb = x.shape[1] * ss
    return sb, ss


def check_operand(name: str, x: torch.Tensor, device, dtype, hd: int,
                  tensor_core: bool | None = None) -> None:
    """Raise unless `x` is a CUDA tensor of the kernel's type whose last two
    axes (heads, its width `hd`) are dense and whose strides and address
    allow the body's accesses: 4-element vectors on the CUDA cores; on the
    tensor cores (`tensor_core`, by default `tensor_core_body(dtype, hd)`),
    TMA's (or cp.async's) 16-byte-aligned address and strides in multiples
    of 16 bytes."""
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, "
                         f"got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype} differs from q's {dtype}")
    if x.stride(-1) != 1 or x.stride(-2) != hd:
        raise ValueError(f"{name}: the (heads, head_dim) axes must be dense, "
                         f"got strides {x.stride()}")
    if tensor_core is None:
        tensor_core = tensor_core_body(dtype, hd)
    if tensor_core:
        if any(s * x.element_size() % 16 for s in tma_strides(x)) or \
                x.data_ptr() % 16:
            raise ValueError(f"{name}: strides {x.stride()} or address not "
                             "aligned to 16 bytes, as TMA needs")
    elif any(s % 4 for s in x.stride()[:-2]) or \
            x.data_ptr() % (4 * x.element_size()):
        raise ValueError(f"{name}: strides {x.stride()} or address not "
                         "aligned to 4 elements")


def flash_prefill_attention(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, T, K, hd)
    v: torch.Tensor,            # (B, T, K, hd_v)
    q_offset: int = 0,
    kv_len: int | None = None,
    *,
    causal: bool = True,
    local_window: int = 0,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Chunked-causal flash attention on the card. Returns (B, Sq, H, hd_v)
    in q's dtype; rows with no visible key are 0. bf16 at head_dim 64, 128
    or 256, or at q/k 192 with v 128, runs a tensor-core body, everything
    else (at one width) the f32 CUDA-core body. `out`, where given, is
    written and returned: a (B, Sq, H, hd_v) tensor of q's type whose
    (heads, width) axes are dense."""
    B, Sq, H, hd = q.shape
    T, K, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_prefill_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    if hd_v != hd and not tensor_core_body(q.dtype, hd, hd_v):
        raise ValueError(f"flash_prefill_attention: q/k width {hd} with v "
                         f"width {hd_v} runs only in bf16 at "
                         f"{MLA_HEAD_DIMS}")
    if hd_v == hd and hd not in HEAD_DIMS:
        raise ValueError(f"flash_prefill_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"flash_prefill_attention: H={H} not a multiple "
                         f"of K={K}")
    if tuple(k.shape) != (B, T, K, hd) or tuple(v.shape) != (B, T, K, hd_v):
        raise ValueError(f"flash_prefill_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    tc = tensor_core_body(q.dtype, hd, hd_v)
    for name, x, width in (("q", q, hd), ("k", k, hd), ("v", v, hd_v)):
        check_operand(name, x, q.device, q.dtype, width, tc)
    kv_len = T if kv_len is None else int(kv_len)
    if out is None:
        out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    elif tuple(out.shape) != (B, Sq, H, hd_v):
        raise ValueError(f"flash_prefill_attention: out {tuple(out.shape)} "
                         f"does not match q {tuple(q.shape)} and v's width "
                         f"{hd_v}")
    else:
        check_operand("out", out, q.device, q.dtype, hd_v, tc)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    (q_sb, q_ss), (k_sb, k_ss), (v_sb, v_ss) = map(tma_strides, (q, k, v))
    tensor_core = ctypes.c_int(0)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], B, Sq, T, H, K, hd, hd_v, q_sb, q_ss, k_sb,
             k_ss, v_sb, v_ss, out.stride(0), out.stride(1),
             int(q_offset), kv_len, int(bool(causal)), int(local_window),
             1.0 / math.sqrt(hd), stream, ctypes.byref(tensor_core))
    build.check(lib, err, "flash_prefill_attention")
    counts.bump("flash_prefill_attention")
    if tensor_core.value:
        counts.bump("flash_prefill_wgmma")
    if hd_v != hd:
        counts.bump("flash_prefill_mla")
    return out
