"""What decides `correct`: the program's outputs for a sample of the
window's requests against the plain float32 reference on the same weights
and prompts.

The sample is drawn from the seed before the window opens: the longest
prompt due in the window and others at random, up to the cell's request
and token budget (the reference's time). The requests of the sample that
were served are compared; a cell compares the numbers its limits name
(bench/cells/<cell>.json), each the widest or the median over the sample:

- ``token_gap``: how far the reference's logit of the served first token
  lies below the reference's best, in standard deviations of the
  reference's logits (widest);
- ``logit_err``: the RMS of the first-token logits' error over the RMS of
  the reference's logits about their mean (median);
- ``kv_err`` / ``kv_first_err``: per position, the error of each handed-off
  cache tensor (the architecture's HANDOFF: key and value, for a decoder)
  over its norm; the median over positions, the widest over the tensors,
  over requests and over the first, a middle and the last layer, or at the
  first layer only;
- ``logit_outliers``: compared requests whose own logit error exceeds the
  cell's per-request limit (``each.logit_err``): a fault that reaches a
  few requests only (rows of a batch, a resume after a preemption) and
  that a median would hide (limit 0);
- ``token_argmax``: served first tokens that are not the argmax of the
  served logits (exact: limit 0). With ``logit_outliers`` or ``token_gap``
  it ties the served token to the reference.

The control of these limits is the same reference in float8
(bench/tools/control.py reads it on the card; bench/tests hold it at a
small size).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

NUMBERS = ("token_gap", "logit_err", "kv_err", "kv_first_err",
           "logit_outliers", "token_argmax")


def kv_layers(num_layers: int) -> List[int]:
    return sorted({0, num_layers // 2, num_layers - 1})


def sample(lengths: Sequence[int], seed: int, max_requests: int,
           max_tokens: int) -> List[int]:
    """Indices of the requests to compare: the longest first, then others
    in an order drawn from the seed, while the budget lasts."""
    longest = int(np.argmax(lengths))
    rng = np.random.default_rng([seed, 1])
    picked, tokens = [longest], int(lengths[longest])
    for i in rng.permutation(len(lengths)):
        i = int(i)
        if len(picked) == max_requests:
            break
        if i != longest and tokens + lengths[i] <= max_tokens:
            picked.append(i)
            tokens += int(lengths[i])
    return picked


def _rel(err: torch.Tensor, base: torch.Tensor) -> float:
    return float(err.norm() / base.norm().clamp(min=1e-30))


def per_request(ref_logits: torch.Tensor, ref_kv: Dict,
                tokens: Sequence[int], logits: Sequence[torch.Tensor],
                kv: Sequence[Dict]) -> Dict[str, list]:
    """Each compared prompt's readings: `tokens[p]` its served first token,
    `logits[p]` (V,) its served logits, `kv[p]` {layer: (tensor, ...)} its
    handed-off cache rows, one tensor per HANDOFF key; against the
    reference's `ref_logits` (P, V) and `ref_kv` {(p, layer): (tensor,
    ...)} in the same order. A KV reading is the median over positions of
    each position's relative error, the largest over the tensors: ``kv``
    the largest over the layers, ``kv_first`` at the first layer."""
    out: Dict[str, list] = {"gap": [], "logit": [], "kv": [], "kv_first": [],
                            "argmax": [], "kv_layers": []}
    for p, (tok, lg, kvp) in enumerate(zip(tokens, logits, kv)):
        ref = ref_logits[p].float()
        sd = ref.std().clamp(min=1e-30)
        lg = lg.float().to(ref.device)
        out["gap"].append(float((ref.max() - ref[int(tok)]) / sd))
        out["logit"].append(_rel(lg - ref, ref - ref.mean()))
        out["argmax"].append(int(int(tok) != int(lg.argmax())))
        layers = {}
        for layer, pair in kvp.items():
            for got, want in zip(pair, ref_kv[(p, layer)]):
                err = got.float().to(want.device) - want
                pos = err.flatten(1).norm(dim=1) / \
                    want.flatten(1).norm(dim=1).clamp(min=1e-30)
                layers[layer] = max(layers.get(layer, 0.0),
                                    float(pos.median()))
        out["kv"].append(max(layers.values()))
        out["kv_first"].append(layers[min(layers)])
        out["kv_layers"].append(layers)
    return out


def readings(ref_logits: torch.Tensor, ref_kv: Dict, tokens: Sequence[int],
             logits: Sequence[torch.Tensor], kv: Sequence[Dict],
             each: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Every number a cell may compare, over the prompts of `per_request`:
    the widest token gap, the median logit error, the widest KV errors, the
    prompts whose logit error exceeds `each["logit_err"]` (None without
    it), and the served tokens that are not the argmax of the served
    logits."""
    r = per_request(ref_logits, ref_kv, tokens, logits, kv)
    limit = (each or {}).get("logit_err")
    by_layer = {str(l): max(x[l] for x in r["kv_layers"])
                for l in r["kv_layers"][0]}
    return {"token_gap": max(r["gap"]),
            "logit_err": float(np.median(r["logit"])),
            "kv_err": max(r["kv"]),
            "kv_first_err": max(r["kv_first"]),
            "logit_outliers": None if limit is None else
            float(sum(x > limit for x in r["logit"])),
            "token_argmax": float(sum(r["argmax"])),
            "diagnostics": {"logit_err_max": max(r["logit"]),
                            "logit_err_each": [round(x, 5)
                                               for x in r["logit"]],
                            "kv_err_by_layer": by_layer}}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell compares (the keys of its limits) read, finite
    and within its limit."""
    return all(values.get(k) is not None and np.isfinite(values[k])
               and values[k] <= limits[k] for k in limits)
