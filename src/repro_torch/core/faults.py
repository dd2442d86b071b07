"""Deterministic, seedable fault plans — the failure model shared by
`ClusterSim` and the runtime chaos harness (evaluated-is-deployed, like the
dispatch policies: the SAME `FaultPlan` object drives simulator instance
churn and real thread-pool fault injection).

A `FaultPlan` is an ordered tuple of `FaultEvent`s, each scheduling one
fault on one instance:

  * ``crash``    — the instance dies instantly: queued + running prefills
                   (or resident decodes, ``target="decode"``) are stranded
                   and their KV is lost; rejoins after ``duration``.
  * ``hang``     — the instance stops making progress but does not die;
                   detected by the watchdog after its deadline, then treated
                   as a crash (strand + re-dispatch). Rejoins after
                   ``duration``.
  * ``slowdown`` — every operation on the instance takes ``factor``x as
                   long for ``duration`` seconds (gray failure: the
                   instance stays up and keeps completing work, slowly).
  * ``spot``     — spot preemption with ``notice`` seconds of warning: the
                   instance stops ACCEPTING dispatch at ``time`` (draining)
                   and dies at ``time + notice``; rejoins ``duration``
                   after the kill.
  * ``kv_link``  — the prefill->decode KV transfer link into the instance
                   drops for ``duration`` seconds: in-flight handoffs
                   (DECODE_JOIN) are lost and must be retried elsewhere.

Plans are deterministic: `generate` expands a seed into a reproducible
schedule, presets name the benchmark scenarios (fig26), and
`to_json`/`from_json` round-trip a plan for `--chaos <file>` replay.
"""
from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("crash", "hang", "slowdown", "spot", "kv_link")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault on one instance (times relative to run start)."""
    time: float                      # when the fault fires
    instance: int                    # index within the targeted pool
    kind: str = "crash"              # one of FAULT_KINDS
    duration: float = math.inf       # until rejoin/recovery (inf = never)
    notice: float = 0.0              # spot: drain warning before the kill
    factor: float = 1.0              # slowdown multiplier (>1 = slower)
    target: str = "prefill"          # "prefill" | "decode"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.target not in ("prefill", "decode"):
            raise ValueError(f"unknown fault target {self.target!r}")
        if self.time < 0 or self.notice < 0:
            raise ValueError("fault time/notice must be >= 0")
        if self.duration <= 0:
            raise ValueError("fault duration must be > 0")
        if self.kind == "slowdown" and self.factor <= 1.0:
            raise ValueError("slowdown needs factor > 1")

    @property
    def down_at(self) -> float:
        """When the instance actually stops serving (spot waits out the
        drain notice; everything else is immediate)."""
        return self.time + (self.notice if self.kind == "spot" else 0.0)

    @property
    def up_at(self) -> float:
        """When the instance rejoins the pool (inf = never)."""
        return self.down_at + self.duration


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, time-sorted schedule of `FaultEvent`s."""
    events: Tuple[FaultEvent, ...] = field(default_factory=tuple)
    seed: Optional[int] = None       # provenance when generated

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.time, e.instance))))

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def for_target(self, target: str) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.target == target)

    def max_instance(self, target: str = "prefill") -> int:
        evs = self.for_target(target)
        return max((e.instance for e in evs), default=-1)

    # ------------------------------------------------------------ builders
    @classmethod
    def generate(cls, seed: int, n_instances: int, duration: float, *,
                 rate: float = 0.02,
                 kinds: Sequence[str] = ("crash", "hang", "slowdown", "spot"),
                 mean_outage: float = 8.0,
                 target: str = "prefill") -> "FaultPlan":
        """Expand a seed into a reproducible random schedule: Poisson fault
        arrivals at `rate` faults/sec over `duration`, uniform over
        instances and `kinds`, exponential outage lengths (so most faults
        rejoin within the run — the interesting regime for recovery)."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / max(rate, 1e-9)))
            if t >= duration:
                break
            kind = str(rng.choice(list(kinds)))
            out = float(rng.exponential(mean_outage)) + 0.5
            events.append(FaultEvent(
                time=round(t, 3),
                instance=int(rng.integers(0, n_instances)),
                kind=kind,
                duration=round(out, 3),
                notice=round(float(rng.uniform(0.5, 2.0)), 3)
                if kind == "spot" else 0.0,
                factor=round(float(rng.uniform(2.0, 6.0)), 3)
                if kind == "slowdown" else 1.0,
                target=target))
        return cls(events=tuple(events), seed=seed)

    @classmethod
    def preset(cls, name: str, *, n_instances: int = 4,
               duration: float = 40.0) -> "FaultPlan":
        """Named benchmark scenarios (fig26 / --chaos):

          * ``churn``     — kill 1 of `n_instances` mid-trace, rejoin later
          * ``spot-wave`` — two staggered spot preemptions with notice
          * ``gray``      — one hang + one slowdown (gray failures)
        """
        third = duration / 3.0
        if name == "churn":
            return cls(events=(
                FaultEvent(time=round(third, 3), instance=1, kind="crash",
                           duration=round(third, 3)),
            ))
        if name == "spot-wave":
            return cls(events=(
                FaultEvent(time=round(0.25 * duration, 3), instance=0,
                           kind="spot", notice=1.0,
                           duration=round(0.35 * duration, 3)),
                FaultEvent(time=round(0.45 * duration, 3),
                           instance=min(2, n_instances - 1), kind="spot",
                           notice=1.0, duration=round(0.3 * duration, 3)),
            ))
        if name == "gray":
            return cls(events=(
                FaultEvent(time=round(0.25 * duration, 3), instance=0,
                           kind="hang", duration=round(0.25 * duration, 3)),
                FaultEvent(time=round(0.5 * duration, 3),
                           instance=min(1, n_instances - 1),
                           kind="slowdown", factor=4.0,
                           duration=round(0.25 * duration, 3)),
            ))
        raise ValueError(f"unknown fault preset {name!r}; "
                         f"known: churn, spot-wave, gray")

    # --------------------------------------------------------- persistence
    def to_json(self) -> str:
        def enc(e: FaultEvent) -> dict:
            d = asdict(e)
            if math.isinf(d["duration"]):
                d["duration"] = None          # JSON has no inf
            return d
        return json.dumps({"seed": self.seed,
                           "events": [enc(e) for e in self.events]},
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        events = []
        for e in d.get("events", []):
            if e.get("duration") is None:
                e = dict(e, duration=math.inf)
            events.append(FaultEvent(**e))
        return cls(events=tuple(events), seed=d.get("seed"))

    @classmethod
    def from_spec(cls, spec: str, *, n_instances: int = 4,
                  duration: float = 40.0) -> "FaultPlan":
        """Resolve a CLI ``--chaos`` spec: a preset name (``churn``,
        ``spot-wave``, ``gray``), ``seed:<int>`` for a generated plan, or a
        path to a JSON file written by `to_json`."""
        if spec.startswith("seed:"):
            return cls.generate(int(spec[5:]), n_instances, duration)
        try:
            return cls.preset(spec, n_instances=n_instances,
                              duration=duration)
        except ValueError:
            pass
        try:
            with open(spec) as f:
                return cls.from_json(f.read())
        except OSError:
            raise ValueError(
                f"--chaos spec {spec!r} is neither a preset "
                f"(churn, spot-wave, gray), a seed:<int>, nor a readable "
                f"JSON plan file")


def merge_plans(plans: Iterable[FaultPlan]) -> FaultPlan:
    """Union several plans into one time-sorted schedule."""
    events: List[FaultEvent] = []
    for p in plans:
        events.extend(p.events)
    return FaultPlan(events=tuple(events))
