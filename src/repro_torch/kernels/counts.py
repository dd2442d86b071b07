"""Launch counters of the CUDA kernels and call counters of their plain
versions, so a run can show which path it went through.

The prefill pool worker and the decode worker bump them from two threads,
so every read and write holds one lock: a bare `+= 1` could lose counts.
`kernels.ops.counts()` and `reset_counts()` are the readers.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, Iterable

_lock = threading.Lock()
_counts: Counter = Counter()


def bump(name: str) -> None:
    with _lock:
        _counts[name] += 1


def read(names: Iterable[str]) -> Dict[str, int]:
    with _lock:
        return {name: _counts[name] for name in names}


def reset() -> None:
    with _lock:
        _counts.clear()
