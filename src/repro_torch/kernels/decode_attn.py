"""Flash-decode GQA attention as one CUDA kernel body for Hopper
(`csrc/decode_attn.cu`, whose header note says what bounds it and how it is
laid out: split-KV over fixed splits of 128 keys (32 at head_dim 256),
cp.async loads, bf16 products on the tensor cores, and a second kernel that
combines the splits):

  * `flash_decode_attention` — one new token per row against that row's KV
    view with a per-row valid length (plain version
    `kernels.ref.decode_attention_ref`);
  * `flash_verify_attention` — S = draft_k + 1 consecutive query positions
    per row for the speculative verify step, query s seeing keys
    [0, kv_len[b] + s] (plain version `kernels.ref.verify_attention_ref`).

Both launch the same body: decode is S = 1 with the query at position
kv_len - 1, a shift the C entry point takes as an int. Each launch counts
its wrapper's name and `decode_split_body`, the body's own counter.

Counterparts of the two kernels of src/repro/kernels/decode_attn.py.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, counts
from repro_torch.kernels.flash_prefill import (DTYPES, HEAD_DIMS,
                                               check_operand, tma_strides)

MAX_QG = 16                     # query heads per KV head the decode wrapper takes
MAX_ROWS = 64                   # S * (H / K) query rows the body holds
SPLIT_KEYS = 128                # keys per split up to head_dim 128
BODY = "decode_split_body"      # launch counter of the shared body


def split_keys(hd: int) -> int:
    """Keys per split block of the body at head_dim `hd` (its SPLIT): one
    warp of 32 keys at head_dim 256, four warps below."""
    return 32 if hd > 128 else SPLIT_KEYS

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("decode_attn")
    fn = lib.flash_decode_verify_attention
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float, _P]
    fn.restype = _I
    return lib, fn


def _check_kv(name: str, x: torch.Tensor) -> None:
    """cp.async copies 16-byte chunks of each K/V row."""
    if any(s * x.element_size() % 16 for s in tma_strides(x)) or \
            x.data_ptr() % 16:
        raise ValueError(f"{name}: strides {x.stride()} or address not "
                         "aligned to 16 bytes, as cp.async needs")


def _launch(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            kv_len, out: torch.Tensor, shift: int) -> torch.Tensor:
    """Run the body on q/out viewed as (B, S, H, hd): query s of row b at
    position kv_len[b] + shift + s."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    for name, x in (("k", k), ("v", v)):
        _check_kv(name, x)
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
    lens = lens.reshape(-1).expand(B).contiguous()
    if out.numel() == 0:
        return out
    if T == 0:                  # no key: every row is 0, nothing to launch
        return out.zero_()
    split = split_keys(hd)
    splits = -(-T // split)
    n_ws = B * K * splits * S * (H // K) * (hd + 2)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=q.device)
    lib, fn = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    (k_sb, k_ss), (v_sb, v_ss) = tma_strides(k), tma_strides(v)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
             out.data_ptr(), ws.data_ptr(), n_ws, split,
             DTYPES[q.dtype], B, S, T, H, K, hd, shift,
             q.stride(0), q.stride(1), k_sb, k_ss, v_sb, v_ss,
             out.stride(0), out.stride(1), 1.0 / math.sqrt(hd), stream)
    build.check(lib, err, what)
    counts.bump(what)
    counts.bump(BODY)
    return out


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
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    _launch("flash_decode_attention", q[:, None], k, v, kv_len, out[:, None],
            shift=-1)
    return out


def flash_verify_attention(
    q: torch.Tensor,            # (B, S, H, hd) — S = draft_k + 1 positions
    k: torch.Tensor,            # (B, T, K, hd) with the draft K/V written
    v: torch.Tensor,            # (B, T, K, hd)
    kv_len,                     # int, or (B,) committed lengths (any device)
) -> torch.Tensor:
    """Speculative-verify flash decode on the card: row b scores the S
    positions kv_len[b] .. kv_len[b] + S - 1, query s attending to keys
    [0, kv_len[b] + s] (and < T). Returns (B, S, H, hd) in q's dtype.
    Raises for S * (H / K) above MAX_ROWS."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_verify_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_verify_attention: head_dim {hd} not in "
                         f"{HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"flash_verify_attention: H={H} is not a multiple "
                         f"of K={K}")
    if S * (H // K) > MAX_ROWS:
        raise ValueError(f"flash_verify_attention: S={S} positions x "
                         f"{H // K} query heads per KV head = "
                         f"{S * (H // K)} rows, above the kernel's "
                         f"{MAX_ROWS}")
    if tuple(k.shape) != (B, T, K, hd) or v.shape != k.shape:
        raise ValueError(f"flash_verify_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, q.device, q.dtype, hd)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    return _launch("flash_verify_attention", q, k, v, kv_len, out, shift=0)
