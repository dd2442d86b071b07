"""Plain float32 forward of the decoders the benchmark serves: Qwen2 (dense
SwiGLU, q/k/v biases) and Qwen3-MoE (top-k of E experts, softmax over the k
selected router logits), from the published config keys and the weights the
harness drew.

Independent of the program: plain torch ops only, no kernel, cache or
batching of the port, nothing of `repro_torch`. It reads the weights in the
layout the harness draws them in: stacked per layer under ``layers``; q, k,
v as (d, heads * hd); gate|up as (d, 2, F), or (E, d, 2F) gate first for
the experts; RMSNorm weights stored as the offset w of the scale 1 + w.
Departures from the published models are the configuration file's
(``departures``), which the program shares.

``fp8=True`` is the control of the correctness check: every product's
inputs and the stored keys and values rounded to float8 e4m3 (per-tensor
scale for weights, per-row for activations), products accumulated in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


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
        return self.act(x) @ w          # w already passed through weight()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the two halves of each head. x: (n, heads, hd)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv                       # (n, hd/2)
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal_attention(q, k, v, prec: Precision, block: int = 512):
    """Softmax attention of query i over keys 0..i, heads grouped over the
    K key/value heads. q: (n, H, hd), k/v: (n, K, hd) -> (n, H * hd)."""
    n, H, hd = q.shape
    K = k.shape[1]
    qg = prec.act(q).reshape(n, K, H // K, hd).permute(1, 2, 0, 3)
    kt = prec.act(k).permute(1, 2, 0)                      # (K, hd, n)
    vt = prec.act(v).permute(1, 0, 2)                      # (K, n, hd)
    out = torch.empty(K, H // K, n, hd, device=q.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s = torch.matmul(qg[:, :, lo:hi], kt[:, None, :, :hi]) / math.sqrt(hd)
        mask = torch.arange(hi, device=q.device)[None, :] > \
            torch.arange(lo, hi, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1)
        out[:, :, lo:hi] = torch.matmul(prec.act(p), vt[:, None, :hi])
    return out.permute(2, 0, 1, 3).reshape(n, H * hd)


ROW_BLOCK = 8192        # rows of the dense FFN's products at a time


def _rows(fn, x: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(x[i:i + ROW_BLOCK])
                      for i in range(0, x.shape[0], ROW_BLOCK)])


def forward(weights: Dict, config: Dict, prompts: Sequence[torch.Tensor], *,
            kv_layers: Sequence[int] = (), fp8: bool = False
            ) -> Tuple[torch.Tensor, Dict[Tuple[int, int], Tuple]]:
    """Logits at the last position of each prompt (P, V), and the keys
    (after the rotary embedding) and values of every prompt at each layer of
    `kv_layers`: {(prompt, layer): (k, v)}, each (n, K, hd). All f32."""
    strict_f32()
    prec = Precision(fp8)
    d = config["hidden_size"]
    H, K = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config.get("head_dim", d // H)
    eps, theta = config["rms_norm_eps"], config["rope_theta"]
    top_k = config.get("num_experts_per_tok", 0)
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
        w = {key: val[l].float() for key, val in lw.items()}
        x = rms_norm(h, w["ln1"], eps)
        q, k, v = (prec.mm(x, prec.weight(w[m])) for m in ("wq", "wk", "wv"))
        if "bq" in w:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
        q = rope(q.reshape(-1, H, hd), pos, theta)
        k = rope(k.reshape(-1, K, hd), pos, theta)
        v = v.reshape(-1, K, hd)
        if fp8:                                  # the cache held in fp8
            k, v = round_fp8(k, True), round_fp8(v, True)
        attn = torch.empty(h.shape[0], H * hd, device=dev)
        for i, (a, b) in enumerate(zip(starts, starts[1:])):
            attn[a:b] = causal_attention(q[a:b], k[a:b], v[a:b], prec)
            if l in kv_layers:
                kv[(i, l)] = (k[a:b].clone(), v[a:b].clone())
        h = h + prec.mm(attn, prec.weight(w["wo"]))
        x = rms_norm(h, w["ln2"], eps)
        if "router" in w:
            h = h + _moe(x, w, top_k, prec)
        else:
            wi = prec.weight(w["wi"].reshape(d, -1))
            wd = prec.weight(w["wd"])
            Fd = wd.shape[0]

            def ffn(xb):
                gu = prec.mm(xb, wi)
                return prec.mm(F.silu(gu[:, :Fd]) * gu[:, Fd:], wd)
            h = h + _rows(ffn, x)
        del w
    last = h[torch.tensor(starts[1:], device=dev) - 1]
    x = rms_norm(last, weights["final_norm"].float(), eps)
    head = weights["embed"].T if config["tie_word_embeddings"] \
        else weights["unembed"]
    logits = prec.mm(x, prec.weight(head.float()))
    return logits, kv


def _moe(x: torch.Tensor, w: Dict, top_k: int, prec: Precision):
    """Each token's top_k experts by router logit, weighted by the softmax
    of those k logits; every routed (token, expert) pair computed."""
    logits = prec.mm(x, prec.weight(w["router"]))          # (T, E)
    top, idx = torch.topk(logits, top_k, dim=-1)
    gate_w = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    E, _, F2 = w["wi"].shape
    Fd = F2 // 2
    for e in range(E):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        gu = prec.mm(x[rows], prec.weight(w["wi"][e]))
        ye = prec.mm(F.silu(gu[:, :Fd]) * gu[:, Fd:], prec.weight(w["wd"][e]))
        y.index_add_(0, rows, ye * gate_w[rows, slot][:, None])
    return y
