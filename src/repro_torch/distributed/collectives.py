"""HLO collective analysis: parse compiled/lowered HLO text and sum operand
bytes per collective kind (all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute). cost_analysis() does not expose collective
traffic, so the roofline's collective term comes from here.

Shapes in post-SPMD HLO are per-device shard shapes; we report per-device
operand bytes (multiply by chip count for global traffic).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
# e.g.  %all-reduce.7 = bf16[16,128]{1,0} all-reduce(bf16[16,128]{1,0} %x), ...
_LINE_RE = re.compile(
    r"=\s*(?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum of operand bytes per collective kind (per device, one execution)."""
    out: Dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        m = _LINE_RE.search(line)
        if not m:
            continue
        kind = m.group(1)
        if "-done(" in line:
            continue                      # started op already counted
        # operand shapes are the shape tokens after the op-name paren
        paren = line.index(m.group(0)) + len(m.group(0))
        operands = line[paren - 1:]
        shapes = _SHAPE_RE.findall(operands)
        if not shapes:                    # fall back to the result shape
            shapes = _SHAPE_RE.findall(line[:paren])[:1]
        for dtype, dims in shapes:
            out[kind] += _shape_bytes(dtype, dims)
    return dict(out)


def total_collective_bytes(hlo_text: str) -> int:
    return sum(collective_bytes(hlo_text).values())
