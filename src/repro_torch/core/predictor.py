"""Lightweight TTFT predictor (FlowPrefill §6.4, Fig. 13).

A polynomial fitted to offline prefill profiles: x = token count, y = prefill
latency. Degree 2 captures the linear GEMM term plus the quadratic attention
term; in the PD-disaggregated setting prefill latency is undisturbed by decode,
so this simple fit suffices (validated in benchmarks/fig13_predictor.py).

`predict` is THE scheduler/dispatch hot path (hundreds of calls per arrival at
cluster scale: S-EDF feasibility + competing-work pricing), so it evaluates
the polynomial with an inline Horner loop over cached float coefficients —
the exact IEEE operation sequence of np.polyval, ~20x faster on scalars.

`OnlineTTFTPredictor` adds predictor feedback (ROADMAP dispatch extension):
it starts from an offline prior and refits the polynomial from a sliding
window of observed (tokens, latency) pairs, so a mis-calibrated prior — e.g.
a predictor fitted on one hardware generation deployed on another in a
heterogeneous pool — converges to the instance's true cost curve.

`DecodeStepPredictor` is the decode-phase counterpart: the decode S-EDF
scheduler (core/scheduler.py `DecodeSchedulerCore`) needs predicted per-token
step times to compute TBT-deadline slack. The prior is analytic
(`DecodeCostModel.step_time(batch, mean_context)` — decode is memory-bound, so
the two-term weights+KV model is accurate), and observed per-token latencies
calibrate a single multiplicative scale via an EMA, so slack estimates track
the real hardware the way OnlineTTFTPredictor tracks prefill speed.
"""
from __future__ import annotations

import json
import threading
import warnings
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def expected_accept_tokens(accept_rate: float, draft_k: int) -> float:
    """Analytic E[tokens/step] of greedy draft-then-verify with per-token
    accept probability ``a`` and draft length ``k``: the step commits the
    current token plus the longest accepted draft prefix, so

        E = 1 + a + a^2 + ... + a^k = (1 - a^{k+1}) / (1 - a)

    This is the shared accept-rate surface: `DecodeSim` advances streams by
    it, trace generators stamp per-task accept rates with it in mind, and
    the runtime's EMA estimate converges to it — evaluated-is-deployed."""
    a = min(max(float(accept_rate), 0.0), 1.0)
    k = max(int(draft_k), 0)
    if k == 0:
        return 1.0
    if a >= 1.0:
        return float(k + 1)
    return float((1.0 - a ** (k + 1)) / (1.0 - a))


@dataclass
class TTFTPredictor:
    coeffs: np.ndarray                   # np.polyval order (highest first)
    floor: float = 0.0                   # minimum latency (dispatch overhead)

    # Horner cache: (source array, coefficients as python floats). Rebuilt
    # whenever `coeffs` is rebound (online refit), checked by identity.
    _horner: Optional[Tuple[np.ndarray, Tuple[float, ...]]] = \
        field(default=None, repr=False, compare=False)

    @classmethod
    def fit(cls, tokens: Sequence[float], latencies: Sequence[float],
            degree: int = 2) -> "TTFTPredictor":
        tokens = np.asarray(tokens, dtype=np.float64)
        latencies = np.asarray(latencies, dtype=np.float64)
        coeffs = np.polyfit(tokens, latencies, degree)
        floor = float(max(latencies.min() * 0.5, 0.0))
        return cls(coeffs=coeffs, floor=floor)

    @classmethod
    def from_cost_model(cls, cost_fn, max_tokens: int = 65536,
                        n_points: int = 64, degree: int = 2) -> "TTFTPredictor":
        """Fit against an analytic cost model (sim calibration path)."""
        xs = np.linspace(64, max_tokens, n_points)
        ys = np.array([cost_fn(int(x)) for x in xs])
        return cls.fit(xs, ys, degree)

    def _coeff_tuple(self) -> Tuple[float, ...]:
        cached = self._horner
        if cached is None or cached[0] is not self.coeffs:
            cached = (self.coeffs, tuple(float(c) for c in self.coeffs))
            self._horner = cached
        return cached[1]

    def predict(self, num_tokens: float) -> float:
        x = max(float(num_tokens), 0.0)
        y = 0.0
        for c in self._coeff_tuple():    # Horner — np.polyval's op sequence
            y = y * x + c
        return max(y, self.floor)

    def predict_many(self, num_tokens: np.ndarray) -> np.ndarray:
        """Vectorized predict over an array of token counts (elementwise
        identical to `predict`: same Horner recurrence, same floor clamp)."""
        x = np.maximum(np.asarray(num_tokens, dtype=np.float64), 0.0)
        y = np.zeros_like(x)
        for c in self._coeff_tuple():
            y = y * x + c
        return np.maximum(y, self.floor)

    def __call__(self, num_tokens: float) -> float:
        return self.predict(num_tokens)

    # --- persistence (offline fit shipped with a deployment) ---------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"coeffs": self.coeffs.tolist(), "floor": self.floor}, f)

    @classmethod
    def load(cls, path: str) -> "TTFTPredictor":
        with open(path) as f:
            d = json.load(f)
        return cls(coeffs=np.asarray(d["coeffs"]), floor=d["floor"])


@dataclass
class OnlineTTFTPredictor(TTFTPredictor):
    """TTFT predictor with online refit from observed prefill latencies.

    Serves predictions from the prior until `min_points` observations arrive,
    then refits the polynomial over a sliding window every `refit_every`
    observations. The refit degree is capped by the number of distinct token
    counts seen, so early refits with clustered observations stay
    well-conditioned instead of extrapolating a wild quadratic.

    `observe` is thread-safe: the real Proxy feeds it from every prefill
    instance's scheduler thread. `predict` stays lock-free — it reads one
    rebound `coeffs` reference, which is atomic.
    """
    window: int = 256                    # observations kept for refitting
    min_points: int = 8                  # observations before the first refit
    refit_every: int = 8                 # refit cadence (in observations)
    degree: int = 2

    _obs_x: List[float] = field(default_factory=list, repr=False,
                                compare=False)
    _obs_y: List[float] = field(default_factory=list, repr=False,
                                compare=False)
    _obs_lock: threading.Lock = field(default_factory=threading.Lock,
                                      repr=False, compare=False)
    _since_refit: int = field(default=0, repr=False, compare=False)
    n_observed: int = field(default=0, repr=False, compare=False)
    n_refits: int = field(default=0, repr=False, compare=False)

    @classmethod
    def from_predictor(cls, base: TTFTPredictor,
                       **kwargs) -> "OnlineTTFTPredictor":
        return cls(coeffs=np.array(base.coeffs, copy=True), floor=base.floor,
                   **kwargs)

    def observe(self, num_tokens: float, latency: float) -> None:
        """Feed one observed (tokens, prefill latency) pair; refits lazily."""
        if num_tokens <= 0 or latency <= 0:
            return
        with self._obs_lock:
            self._obs_x.append(float(num_tokens))
            self._obs_y.append(float(latency))
            if len(self._obs_x) > self.window:
                del self._obs_x[0], self._obs_y[0]
            self.n_observed += 1
            self._since_refit += 1
            if len(self._obs_x) >= self.min_points and \
                    self._since_refit >= self.refit_every:
                self._refit()

    def _refit(self) -> None:
        # caller holds _obs_lock
        self._since_refit = 0
        deg = min(self.degree, len(set(self._obs_x)) - 1)
        if deg < 1:
            return                       # degenerate window (one token count)
        xs = np.asarray(self._obs_x)
        ys = np.asarray(self._obs_y)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # poorly conditioned early fits
            self.coeffs = np.polyfit(xs, ys, deg)
        self.floor = float(max(ys.min() * 0.5, 0.0))
        self.n_refits += 1


@dataclass
class MeasuredStepTime:
    """Measured decode step-time surface — the PROFILED prior for
    `DecodeStepPredictor`, replacing the purely analytic seed.

    Decode latency has the two-term memory-bound structure of
    `DecodeCostModel.step_time` (a fixed weight-stream + per-launch cost,
    plus a per-stream KV-stream term), so the surface

        t(B, ctx) = c0 + c1 * B + c2 * B * ctx

    fitted by least squares over profiled ``(batch, mean_context, seconds)``
    samples (`repro_torch.serving.decode_instance.profile_step_times` measures them
    from the real jitted batched step) captures the deployed hardware's
    actual curve — including host/dispatch overheads the analytic model can
    only approximate. Negative slope terms (a noisy profile can fit c1/c2
    below zero) are clamped to zero AT FIT TIME with the intercept refit, so
    the surface stays monotone non-decreasing in batch and context — a
    latency model claiming bigger batches are faster would invert every
    S-EDF slack ranking built on it.
    """
    c0: float
    c1: float
    c2: float
    n_samples: int = 0
    floor: float = 1e-9

    @classmethod
    def fit(cls, samples: Sequence[Tuple[int, float, float]]
            ) -> "MeasuredStepTime":
        """samples: [(batch_size, mean_context, seconds_per_step)]."""
        pts = [(float(b), float(c), float(t)) for b, c, t in samples]
        if not pts:
            raise ValueError("MeasuredStepTime.fit needs >= 1 sample")
        y = np.array([t for _, _, t in pts])
        cols = [np.ones(len(pts)),
                np.array([b for b, _, _ in pts]),
                np.array([b * c for b, c, _ in pts])]
        keep = [0, 1, 2]
        coef = np.zeros(3)
        while True:
            A = np.stack([cols[i] for i in keep], axis=1)
            sol, *_ = np.linalg.lstsq(A, y, rcond=None)
            coef = np.zeros(3)
            coef[keep] = sol
            # clamp negative slope terms and refit the rest (active-set
            # style): monotone non-decreasing in B and ctx by construction
            neg = [i for i in keep if i != 0 and coef[i] < 0.0]
            if not neg:
                break
            keep = [i for i in keep if i not in neg]
        floor = float(max(y.min() * 0.25, 1e-9))
        return cls(c0=float(coef[0]), c1=float(coef[1]), c2=float(coef[2]),
                   n_samples=len(pts), floor=floor)

    def __call__(self, batch_size: int, mean_context: float) -> float:
        t = self.c0 + self.c1 * batch_size \
            + self.c2 * batch_size * max(mean_context, 0.0)
        return max(t, self.floor)

    def rel_err(self, samples: Sequence[Tuple[int, float, float]]) -> float:
        """Mean relative error of the fitted surface over `samples` (fit
        quality / holdout agreement — the fig21 gate metric)."""
        errs = [abs(self(b, c) - t) / max(t, 1e-12) for b, c, t in samples]
        return float(np.mean(errs)) if errs else 0.0


@dataclass
class DecodeStepPredictor:
    """Per-token decode step-time predictor (decode S-EDF's latency model).

    Wraps a prior ``(batch_size, mean_context) -> seconds`` — the analytic
    `DecodeCostModel.step_time`, or a `MeasuredStepTime` surface profiled
    from the real batched step (`from_profile`) — and calibrates it with a
    single multiplicative scale learned from observed per-token latencies via
    an EMA: decode latency is dominated by one memory-bandwidth term, so a
    scale on the prior curve absorbs most hardware mis-calibration — a full
    refit like OnlineTTFTPredictor's polynomial is unnecessary here.

    With no observations the predictor IS the prior (scale 1.0): the fluid
    simulator uses it un-calibrated so scheduling decisions stay bit-aligned
    with the cost model it is evaluated against; the threaded DecodeInstance
    feeds `observe` from its own worker, one predictor per instance.
    """
    prior: Callable[[int, float], float]
    ema_alpha: float = 0.1               # EMA weight of a new observation
    scale: float = 1.0
    n_observed: int = 0

    # --- speculative-decoding accept-rate surface --------------------------
    # Under speculation a stream commits 1..k+1 tokens per step, so the
    # honest per-ACCEPTED-token service time is step_time / E[tokens/step].
    # Both an aggregate and a per-stream EMA of observed tokens/step are
    # kept: S-EDF slack and migration gating price a specific stream (its
    # own accept behaviour), while batch-level budgets use the aggregate.
    accept_alpha: float = 0.25           # EMA weight for tokens/step updates
    _tps_all: float = field(default=0.0, repr=False, compare=False)
    _tps_by_key: dict = field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def from_profile(cls, samples: Sequence[Tuple[int, float, float]],
                     **kwargs) -> "DecodeStepPredictor":
        """Build a predictor whose prior is a `MeasuredStepTime` surface
        fitted to profiled ``(batch, mean_context, seconds)`` samples from
        the real jitted step (see
        `repro_torch.serving.decode_instance.profile_step_times`)."""
        return cls(prior=MeasuredStepTime.fit(samples), **kwargs)

    def step_time(self, batch_size: int, mean_context: float) -> float:
        return self.prior(batch_size, mean_context) * self.scale

    def observe(self, batch_size: int, mean_context: float,
                measured: float) -> None:
        """Feed one measured per-token step latency for calibration."""
        base = self.prior(batch_size, mean_context)
        if base <= 0.0 or measured <= 0.0:
            return
        ratio = measured / base
        self.scale += self.ema_alpha * (ratio - self.scale)
        self.n_observed += 1

    def observe_accept(self, key: int, tokens_committed: float) -> None:
        """Feed the number of tokens one decode step committed for stream
        ``key`` (1 = draft fully rejected or no draft; k+1 = fully
        accepted). Updates the per-stream and aggregate tokens/step EMAs."""
        t = float(tokens_committed)
        if t < 1.0:
            return
        prev = self._tps_by_key.get(key)
        self._tps_by_key[key] = t if prev is None \
            else prev + self.accept_alpha * (t - prev)
        self._tps_all = t if self._tps_all <= 0.0 \
            else self._tps_all + self.accept_alpha * (t - self._tps_all)

    def expected_tokens_per_step(self, key: Optional[int] = None) -> float:
        """E[tokens committed per decode step] — per-stream EMA when `key`
        has been observed, else the aggregate; 1.0 (plain decoding) before
        any observation. Never below 1.0: a step always commits the current
        token."""
        if key is not None:
            v = self._tps_by_key.get(key)
            if v is not None:
                return max(v, 1.0)
        return max(self._tps_all, 1.0) if self._tps_all > 0.0 else 1.0

    def forget_stream(self, key: int) -> None:
        """Drop a finished/migrated stream's accept-rate state."""
        self._tps_by_key.pop(key, None)
