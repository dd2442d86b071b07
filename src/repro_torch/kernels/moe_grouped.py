"""The `experts` operator of an MoE layer over its routed pairs only, as CUDA
kernels for Hopper (`csrc/moe_grouped.cu`, whose header note says what
bounds them and how they are laid out): the route, the gate|up and down
grouped GEMMs and the combine, six launches from one C call.

It replaces no kernel of the JAX package, whose experts are one-hot einsums
(src/repro/models/layers.py `moe_apply`); it was added because the port's
plain version, `models.layers.moe_apply_ref`, runs every expert over every
capacity slot. It keeps the same pairs as that version (the reference's
queue rule within each group, pos < cap, only experts [e0, e0 + El)), and
`models.layers.moe_route_ref` is the plain twin of its routing.

Every grid is sized from the token count and the experts alone and the
routing is read on the device, so a call makes no host sync and can be
captured in a CUDA graph. Every call counts `moe_grouped_gemm`, a call on
the tensor-core GEMMs (bf16, D a multiple of 128, F of 64) also
`moe_grouped_wgmma`; the others (f32, other widths) run CUDA-core GEMMs.
`counts()` reads them beside `moe_apply_ref`, the plain version's calls
(`kernels.ops.reset_counts()` clears them).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import counts as _counts

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_M = 128                  # rows of an M tile (csrc `BM`)
MAX_K = 64
MAX_EXPERTS = 1024
# the workspace's parts, in the order of csrc `layout`
PARTS = ("pos", "cnt", "grp_base", "row_off", "tiles", "meta", "pair_row",
         "xg", "inter", "ye")

COUNTED = ("moe_grouped_gemm", "moe_grouped_wgmma", "moe_apply_ref")

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.load("moe_grouped")
    fn = lib.moe_grouped_ffn
    fn.argtypes = [_P] * 8 + [_I] * 10 + [_P, ctypes.POINTER(_I)]
    fn.restype = _I
    lay = lib.moe_grouped_layout
    lay.argtypes = [_I] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    lay.restype = _I
    return lib, fn, lay


@functools.lru_cache(maxsize=256)
def layout(n: int, k: int, G: int, E: int, El: int, D: int, F: int,
           es: int) -> Tuple[int, ...]:
    """Byte offsets of the workspace's `PARTS` and its size (last)."""
    _, _, lay = _kernel()
    off = (ctypes.c_longlong * (len(PARTS) + 1))()
    lay(n, k, G, E, El, D, F, es, off)
    return tuple(off)


def counts() -> Dict[str, int]:
    """Calls of the kernel and of its plain version since the last reset."""
    return _counts.read(COUNTED)


def tensor_core_body(dtype: torch.dtype, D: int, F: int) -> bool:
    """Whether a call runs the tensor-core GEMMs (the C entry point makes
    the same choice and reports it)."""
    return dtype == torch.bfloat16 and D % 128 == 0 and F % 64 == 0


def _dense(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"moe_grouped_ffn: {name} on {t.device}, x on "
                         f"{device}")
    if t.dtype != dtype:
        raise ValueError(f"moe_grouped_ffn: {name} is {t.dtype}, expected "
                         f"{dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"moe_grouped_ffn: {name} must be a contiguous "
                         f"{tuple(shape)}, got {tuple(t.shape)} strides "
                         f"{t.stride()}")


def moe_grouped_ffn(x: torch.Tensor, weights: torch.Tensor,
                    idx: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor, *, n_groups: int, cap: int,
                    n_experts: int = 0, e0: int = 0,
                    residual: Optional[torch.Tensor] = None,
                    workspace: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The experts of n tokens on the card: x (n, D) f32 or bf16 routed to
    idx (n, k) int64 with weights (n, k) f32, in `n_groups` groups of n /
    n_groups tokens at capacity `cap` per expert and group; w_gate_up (El,
    D, 2F) [gate | up] and w_down (El, F, D) hold experts [e0, e0 + El) of
    `n_experts` (default El). Returns the combine (n, D) in x's dtype, or,
    with `residual` (n, D), residual + combine written into it. A
    `workspace` (uint8, at least `layout(...)[-1]` bytes) is used in place
    of a fresh one, so a test can read the routing it holds."""
    n, D = x.shape
    k = idx.shape[-1]
    El, _, F2 = w_gate_up.shape
    F = F2 // 2
    E = n_experts or El
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"moe_grouped_ffn: expected CUDA tensors, got {dev}")
    if x.dtype not in DTYPES:
        raise ValueError(f"moe_grouped_ffn: dtype {x.dtype} not in "
                         f"{list(DTYPES)}")
    if not 0 < k <= MAX_K or not 0 < E <= MAX_EXPERTS or \
            not 0 <= e0 <= E - El or n_groups <= 0 or n % n_groups:
        raise ValueError(f"moe_grouped_ffn: k {k}, experts [{e0}, "
                         f"{e0 + El}) of {E} or {n_groups} groups of {n} "
                         f"tokens out of range")
    _dense("x", x, (n, D), x.dtype, dev)
    _dense("weights", weights, (n, k), torch.float32, dev)
    _dense("idx", idx, (n, k), torch.int64, dev)
    _dense("w_gate_up", w_gate_up, (El, D, 2 * F), x.dtype, dev)
    _dense("w_down", w_down, (El, F, D), x.dtype, dev)
    tc = tensor_core_body(x.dtype, D, F)
    if tc and (w_gate_up.data_ptr() % 16 or w_down.data_ptr() % 16):
        raise ValueError("moe_grouped_ffn: expert weights not aligned to 16 "
                         "bytes, as TMA needs")
    if residual is None:
        out = torch.empty((n, D), dtype=x.dtype, device=dev)
    else:
        _dense("residual", residual, (n, D), x.dtype, dev)
        out = residual
    if n == 0:
        return out if residual is not None else out.zero_()
    size = layout(n, k, n_groups, E, El, D, F, x.element_size())[-1]
    if workspace is None:
        workspace = torch.empty(size, dtype=torch.uint8, device=dev)
    elif workspace.numel() < size or workspace.device != dev:
        raise ValueError(f"moe_grouped_ffn: workspace of {workspace.numel()}"
                         f" bytes on {workspace.device}, {size} needed")
    lib, fn, _ = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    tensor_core = ctypes.c_int(0)
    err = fn(x.data_ptr(), weights.data_ptr(), idx.data_ptr(),
             w_gate_up.data_ptr(), w_down.data_ptr(),
             None if residual is None else residual.data_ptr(),
             out.data_ptr(), workspace.data_ptr(), DTYPES[x.dtype], n, k,
             n_groups, int(cap), E, int(e0), El, D, F, stream,
             ctypes.byref(tensor_core))
    build.check(lib, err, "moe_grouped_ffn")
    _counts.bump("moe_grouped_gemm")
    if tensor_core.value:
        _counts.bump("moe_grouped_wgmma")
    return out

