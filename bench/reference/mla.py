"""Plain float32 forward of the DeepSeek-V3-style decoders the benchmark
serves (Kanana-2-30B-A3B), from the published config keys and the weights
the harness drew.

Independent of the program: plain torch ops only, no kernel, cache or
batching of the port, nothing of `repro_torch`. Computed in the published
order (`modeling_deepseek_v3`): q = x W_q (no q LoRA); [c_kv, k_pe] = x
W_kv_a; c_kv RMS-normed and up-projected by W_kv_b to each head's k_nope
and v; the rotary dims of q and k_pe de-interleaved (even dims first: the
published `rope_interleave` true, which `arch/mla.py` requires) and
rotated by split halves; k_pe shared by the heads; softmax scale 1/sqrt(qk_head_dim); the first `first_k_dense_replace`
layers a dense SwiGLU, the others the experts chosen by top-k of
sigmoid(x W_r) + e_score_correction_bias (one group), weighted by their
sigmoid scores over the chosen scores' sum times routed_scaling_factor,
plus the shared experts (one SwiGLU of n_shared_experts x the expert
width).

It reads the weights in the layout the harness draws them in (the
program's `model_shapes`): stacked per layer under ``layers``; each matrix
(in, out), the transpose of the published `nn.Linear` weight; q per head
[nope | rope], W_kv_a's output [c_kv | k_pe], W_kv_b's per head [k_nope |
v]; gate|up as (d, 2, F), or (E, d, 2F) gate first for the routed experts;
RMSNorm weights stored as the offset w of the scale 1 + w; the dense
layers' FFN (`wi_dense`, `wd_dense`) and the MoE layers' leaves (`router`,
`router_bias`, `wi`, `wd`, `wi_shared`, `wd_shared`) stacked over those
layers alone. A layer's weights are cast to f32 as it runs (the whole
model in f32 would take 123 GB).

The handed-off cache it returns is the latent of each (prompt, layer):
c_kv (n, 1, rank) after its norm and k_pe (n, 1, dr) after the rotation,
in the program's HANDOFF order. Departures from the published code: none
in the mathematics; it is f32 throughout where the published model runs
bf16.

``fp8=True`` is the control of the correctness check: every product's
inputs and the stored latent rounded to float8 e4m3 (per-tensor scale for
weights, per-row for activations), products accumulated in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
ROW_BLOCK = 8192        # rows of the dense products at a time
Q_BLOCK = 512           # query rows of the attention's scores at a time
MOE_KEYS = ("router", "router_bias", "wi", "wd", "wi_shared", "wd_shared")


def strict_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """x rounded to float8 e4m3 under an amax scale, back in f32."""
    amax = x.abs().amax(dim=-1, keepdim=True) if per_row else x.abs().amax()
    scale = torch.clamp(amax, min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x, True) if self.fp8 else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return round_fp8(w, False) if self.fp8 else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.act(x[i:i + ROW_BLOCK]) @ w
                          for i in range(0, x.shape[0], ROW_BLOCK)])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(x0, y0, x1, y1, ...) -> (x0, x1, ..., y0, y1, ...) on the last
    axis, as `apply_rotary_pos_emb_interleave` reorders the rotary dims."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2) \
        .flatten(-2)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotation of x (n, ..., r) at positions pos (n,)."""
    r = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                       device=x.device) / r)
    ang = pos.float()[:, None] * inv
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (r // 2,)
    cos, sin = ang.cos().reshape(shape), ang.sin().reshape(shape)
    a, b = x[..., :r // 2], x[..., r // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal_attention(q, k, v, scale: float, prec: Precision):
    """Softmax attention of query i over keys 0..i, one prompt. q/k (n, H,
    dq), v (n, H, dv) -> (n, H * dv), queries in blocks of Q_BLOCK."""
    n, H, _ = q.shape
    qh, kt = prec.act(q).transpose(0, 1), prec.act(k).permute(1, 2, 0)
    vh = prec.act(v).transpose(0, 1)                    # (H, n, dv)
    out = torch.empty(H, n, v.shape[-1], device=q.device)
    for lo in range(0, n, Q_BLOCK):
        hi = min(lo + Q_BLOCK, n)
        s = torch.matmul(qh[:, lo:hi], kt[:, :, :hi]) * scale
        mask = torch.arange(hi, device=q.device)[None, :] > \
            torch.arange(lo, hi, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        out[:, lo:hi] = torch.matmul(prec.act(p), vh[:, :hi])
    return out.transpose(0, 1).reshape(n, -1)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wd: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """wi (d, 2, F) gate|up, wd (F, d)."""
    wi = prec.weight(wi.reshape(wi.shape[0], -1))
    wd = prec.weight(wd)
    Fd = wd.shape[0]
    gu = prec.mm(x, wi)
    return prec.mm(F.silu(gu[:, :Fd]) * gu[:, Fd:], wd)


def moe(x: torch.Tensor, w: Dict, top_k: int, scale: float,
        prec: Precision) -> torch.Tensor:
    """The routed experts of each token and the shared experts."""
    scores = torch.sigmoid(prec.mm(x, prec.weight(w["router"])))
    idx = torch.topk(scores + w["router_bias"], top_k, dim=-1).indices
    gate = scores.gather(1, idx)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-20) * scale
    y = swiglu(x, w["wi_shared"], w["wd_shared"], prec)
    E, _, F2 = w["wi"].shape
    Fd = F2 // 2
    for e in range(E):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        gu = prec.mm(x[rows], prec.weight(w["wi"][e]))
        ye = prec.mm(F.silu(gu[:, :Fd]) * gu[:, Fd:], prec.weight(w["wd"][e]))
        y.index_add_(0, rows, ye * gate[rows, slot][:, None])
    return y


def _layer(lw: Dict, l: int, n_dense: int) -> Dict[str, torch.Tensor]:
    """Layer l's leaves in f32: the attention's, and the dense FFN's or the
    MoE layer's."""
    out = {}
    for key, val in lw.items():
        if key in MOE_KEYS:
            if l >= n_dense:
                out[key] = val[l - n_dense].float()
        elif key.endswith("_dense"):
            if l < n_dense:
                out[key[:-len("_dense")]] = val[l].float()
        else:
            out[key] = val[l].float()
    return out


def forward(weights: Dict, config: Dict, prompts: Sequence[torch.Tensor], *,
            kv_layers: Sequence[int] = (), fp8: bool = False
            ) -> Tuple[torch.Tensor, Dict[Tuple[int, int], Tuple]]:
    """Logits at the last position of each prompt (P, V), and the latent of
    every prompt at each layer of `kv_layers`: {(prompt, layer): (c_kv (n,
    1, rank), k_pe (n, 1, dr))}. All f32."""
    strict_f32()
    prec = Precision(fp8)
    H = config["num_attention_heads"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, rank = config["v_head_dim"], config["kv_lora_rank"]
    eps, theta = config["rms_norm_eps"], float(config["rope_theta"])
    n_dense = config["first_k_dense_replace"]
    scale = 1.0 / math.sqrt(dn + dr)
    lw = weights["layers"]
    dev = weights["embed"].device
    lens = [int(p.numel()) for p in prompts]
    starts = [0]
    for n in lens:
        starts.append(starts[-1] + n)
    toks = torch.cat([p.to(dev).long() for p in prompts])
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    h = weights["embed"][toks].float()
    kv = {}
    for l in range(config["num_hidden_layers"]):
        w = _layer(lw, l, n_dense)
        x = rms_norm(h, w["ln1"], eps)
        q = prec.mm(x, prec.weight(w["wq"])).unflatten(-1, (H, dn + dr))
        ckv = prec.mm(x, prec.weight(w["wkv_a"]))
        c = rms_norm(ckv[:, :rank], w["kv_norm"], eps)
        q = torch.cat([q[..., :dn], rope(deinterleave(q[..., dn:]), pos,
                                         theta)], dim=-1)
        k_pe = rope(deinterleave(ckv[:, rank:]), pos, theta)
        if fp8:                                  # the cache held in fp8
            c, k_pe = round_fp8(c, True), round_fp8(k_pe, True)
        wkv_b = prec.weight(w["wkv_b"])
        attn = torch.empty(h.shape[0], H * dv, device=dev)
        for i, (a, b) in enumerate(zip(starts, starts[1:])):
            up = prec.mm(c[a:b], wkv_b).unflatten(-1, (H, dn + dv))
            k = torch.cat([up[..., :dn],
                           k_pe[a:b, None].expand(-1, H, -1)], dim=-1)
            attn[a:b] = causal_attention(q[a:b], k, up[..., dn:].contiguous(),
                                         scale, prec)
            if l in kv_layers:
                kv[(i, l)] = (c[a:b, None].clone(), k_pe[a:b, None].clone())
            del up, k
        h = h + prec.mm(attn, prec.weight(w["wo"]))
        x = rms_norm(h, w["ln2"], eps)
        if l < n_dense:
            h = h + swiglu(x, w["wi"], w["wd"], prec)
        else:
            h = h + moe(x, w, config["num_experts_per_tok"],
                        config["routed_scaling_factor"], prec)
        del w
    last = h[torch.tensor(starts[1:], device=dev) - 1]
    x = rms_norm(last, weights["final_norm"].float(), eps)
    head = weights["embed"].T if config["tie_word_embeddings"] \
        else weights["unembed"]
    return prec.mm(x, prec.weight(head.float())), kv
