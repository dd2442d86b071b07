"""The measured window: requests offered open loop through `Proxy.submit`,
each stamped with the time it was due, not the time `submit` returned, so a
stall counts against the requests behind it.

While the window runs, the prefills of the requests sampled for the
correctness check leave their first-token logits and their handed-off
caches (the architecture's `HANDOFF` keys of the task's state) at a few
layers here: the harness takes each completed task off
`PrefillInstance.completed_tasks`, where the instance leaves it (with its
whole cache, every row max_seq long) for a consumer, and keeps copies of
the sampled rows only.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

import torch

from harness.traffic import Item


@dataclass
class Capture:
    """The program's outputs for the sampled requests: rid -> last-position
    logits (V,) f32, and rid -> {layer: (one tensor per `handoff` key)} of
    its handed-off cache rows, the first n positions, in the cache dtype."""
    want: Set[int]
    kv_layers: Sequence[int]
    handoff: Sequence[str] = ()       # the architecture's HANDOFF
    logits: Dict[int, torch.Tensor] = field(default_factory=dict)
    kv: Dict[int, Dict[int, Tuple[torch.Tensor, ...]]] = \
        field(default_factory=dict)


def attach(dep, capture: Capture) -> None:
    """Chain the harness after the Proxy's prefill-done callback."""
    inst = dep.prefill
    handoff = inst.on_prefill_done
    stream = getattr(inst, "stream", None)

    def done(task):
        handoff(task)
        st = task.prefill_task.state
        ctx = torch.cuda.stream(stream) if stream is not None else \
            contextlib.nullcontext()
        with ctx:
            for i, req in enumerate(task.requests):
                if req.rid not in capture.want:
                    continue
                n = int(st["lens"][i])
                capture.logits[req.rid] = \
                    task.prefill_task.logits[i].float().clone()
                capture.kv[req.rid] = {
                    l: tuple(st[key][l, i, :n].clone()
                             for key in capture.handoff)
                    for l in capture.kv_layers}
        # the instance keeps every completed task for a consumer; this is it
        inst.completed_tasks.clear()

    inst.on_prefill_done = done


@dataclass
class Window:
    t_open: float
    t_close: float
    t_end: float                      # last first token, or the wait's cap
    requests: List[object]            # the program's Request of each item
    lateness: List[float]             # submit time minus due time, s


def requests(items: Sequence[Item]) -> List[object]:
    """The program's Request of each item; its arrival is set when due."""
    from repro_torch.core.request import Request
    return [Request(num_tokens=it.n, slo=it.slo, task_type=it.task)
            for it in items]


def offer(dep, items: Sequence[Item], reqs: Sequence[object], seconds: float,
          wait_cap: float, t_open: float) -> Window:
    """Submit each request at its due time, stamped with that time; then
    wait until every request has its first token or `wait_cap` seconds past
    the window's close."""
    proxy = dep.proxy
    late = []
    for it, req in zip(items, reqs):
        due = t_open + it.offset
        now = time.monotonic()
        if due > now:
            time.sleep(due - now)
        req.arrival = due
        late.append(time.monotonic() - due)
        proxy.submit(req, it.tokens)
    t_close = t_open + seconds
    deadline = t_close + wait_cap
    while time.monotonic() < deadline and \
            any(r.first_token_time is None for r in reqs):
        time.sleep(0.01)
    done = [r.first_token_time for r in reqs if r.first_token_time is not None]
    t_end = max(done, default=t_close)
    if len(done) < len(reqs):
        t_end = max(t_end, deadline)
    return Window(t_open=t_open, t_close=t_close, t_end=t_end,
                  requests=list(reqs), lateness=late)
