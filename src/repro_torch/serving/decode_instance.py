"""Decode instance (FlowPrefill §4, extended): continuous-batching
autoregressive decode of handed-over prefills (the PD-disaggregation KV
transfer), with pluggable batch-admission scheduling.

Counterpart of src/repro/serving/decode_instance.py. An instance owns up to
``decode_max_batch`` resident SLOTS backed by `PagedKVCache` block tables and
runs ONE decode step per token over the whole resident batch
(`repro_torch.models.model.decode_step_ragged`, whose attention is the CUDA
decode kernel on the card).

Scheduling (`DecodeSchedulerCore`, the reference's own code):

  * ``policy="fcfs"``  — arrival-order admission into free slots; residents
    are never displaced.
  * ``policy="s-edf"`` — admission ranked by TBT-deadline slack; with
    ``preempt`` a near-deadline waiting stream displaces the most slack-rich
    resident at the next TOKEN boundary. Preemption is slot *eviction*:
    progress, KV blocks (kept in the pool) and the next token all survive.

Batch shapes are BUCKETED (``batch_buckets``, KV width padded to power-of-
two block multiples) as in the reference; `compile_cache_size` counts the
distinct (batch bucket, KV width, positions per row) shapes stepped.

``decode_max_batch=1`` keeps the single-stream worker: one dense
`decode_step` per token on the job's own copy of its handoff cache.

On the card the instance owns one CUDA stream, and the worker runs on it.
A handed-over cache is a view of a tensor made on the prefill instance's
stream: ingestion waits on the event the handoff carries (``cache["ready"]``)
and marks the tensors with `record_stream`, so the caching allocator cannot
hand that memory to the prefill stream while this stream still reads it.

Each finished stream's greedy tokens (the prefill's first token, then every
decoded token) are kept in ``outputs[rid]``, from the job's ``output``
record.

Speculative decoding (``spec_decode=True``, the reference's runtime): each
step every resident row proposes up to ``draft_k`` tokens (the self-drafting
n-gram drafter `_ngram_draft` over the stream's own recent tokens, or an
injected ``draft_fn(rid, history, k)``), then ONE batched
`decode_verify_ragged` pass (the CUDA verify kernel on the card) scores all
k+1 positions per row. Greedy acceptance of the longest draft prefix that
matches the argmax chain keeps the output equal to plain greedy decoding;
rejected draft KV is rolled back by committed length
(`PagedKVCache.write_token_span`). Per-stream accept-rate EMAs keep S-EDF
slack and migration gating priced per ACCEPTED token, and a throttle drops
low-accept streams back to drafting nothing, with a periodic re-probe; a
step in which no row drafts runs the plain batched step. The drafter's
corpus is ``DecodeJob.history`` (the reference's: from the resume point on,
capped to the last `_SPEC_HISTORY_CAP` tokens); the output record is kept
apart in ``DecodeJob.output``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.dispatch import DecodeCandidate, DecodeLoad
from repro_torch.core.predictor import DecodeStepPredictor
from repro_torch.core.request import Request
from repro_torch.core.scheduler import DecodeEntry, DecodeSchedulerCore
from repro_torch.models.model import (decode_step, decode_step_ragged,
                                      decode_verify_ragged,
                                      supports_ragged_decode)
from repro_torch.models.segments import on_stream, stream_for
from repro_torch.serving.kvcache import PagedKVCache

# sequence id of the pool slot padding rows write into / gather from — never
# a real request rid (rids are non-negative)
_SCRATCH_SEQ = -1

# per-stream drafter corpus cap: the n-gram drafter scans this many recent
# generated tokens (host memory and host CPU, not device state)
_SPEC_HISTORY_CAP = 512


def _ngram_draft(history: Sequence[int], k: int) -> List[int]:
    """Self-drafting n-gram proposal: find the most recent EARLIER occurrence
    of the stream's current suffix (3-gram first, then 2-gram) in its own
    generated tokens and draft the k tokens that followed it. No weights and
    no device work: repetitive streams hit, low-reuse ones draft nothing and
    the step falls back to plain decoding."""
    n = len(history)
    if k <= 0 or n < 3:
        return []
    for m in (3, 2):
        if n < m + 1:
            continue
        suffix = tuple(history[-m:])
        for i in range(n - m - 1, -1, -1):
            if tuple(history[i:i + m]) == suffix:
                cont = history[i + m:i + m + k]
                if cont:
                    return [int(t) for t in cont]
    return []


@dataclass
class DecodeJob:
    request: Request
    cache: Dict                     # handoff cache {"k", "v": (L, 1, S, K,
                                    # hd), "pos", optionally "ready"}; None
                                    # while the stream's KV lives in the
                                    # instance's paged pool (batched path)
    first_token: int
    tokens_done: int = 0            # tokens already decoded (preemption state)
    next_token: Optional[int] = None  # resume point after a suspension
    enqueued: float = 0.0           # first submit (fixes the decode deadline)
    order: int = 0                  # FCFS order / deterministic tiebreak
    target: int = 0                 # tokens to decode for THIS job
    base_len: int = 0               # prompt tokens in the pool (batched path):
                                    # kv position = base_len + tokens_done
    output: Optional[List[int]] = None    # greedy tokens so far, first_token
                                          # included (DecodeInstance.outputs)
    history: Optional[List[int]] = None   # drafter corpus (spec_decode): the
                                    # tokens from this instance's resume
                                    # point on, capped to _SPEC_HISTORY_CAP;
                                    # None until the first spec step
    probe_in: int = 0               # steps until a throttled stream re-probes
                                    # the drafter (spec_decode)
    private: bool = False           # cache is this instance's own copy (the
                                    # single-stream worker writes it in place)


class DecodeInstance:
    def __init__(self, params, cfg, *, decode_tokens: int = 8,
                 clock: Callable[[], float] = time.monotonic,
                 policy: str = "fcfs", preempt: Optional[bool] = None,
                 step_predictor: Optional[DecodeStepPredictor] = None,
                 decode_max_batch: int = 1,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 kv_block_size: int = 128,
                 prefix_share: bool = False,
                 kv_max_blocks: int = 0,
                 spec_decode: bool = False,
                 draft_k: int = 4,
                 draft_fn: Optional[Callable[
                     [int, Sequence[int], int], Sequence[int]]] = None,
                 spec_probe_period: int = 8,
                 spec_throttle: float = 1.15):
        if decode_max_batch > 1 and not supports_ragged_decode(cfg):
            raise ValueError(
                f"decode_max_batch={decode_max_batch} needs the batched "
                f"ragged decode step, unsupported for family "
                f"{cfg.family!r}; use decode_max_batch=1")
        if spec_decode and not supports_ragged_decode(cfg):
            raise ValueError(
                f"spec_decode needs the batched verify step, unsupported "
                f"for family {cfg.family!r}")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.stream = stream_for(self.device)
        self.decode_tokens = decode_tokens
        self.decode_max_batch = max(decode_max_batch, 1)
        self.clock = clock
        self.sched = DecodeSchedulerCore(
            policy=policy, preempt=(policy == "s-edf") if preempt is None
            else preempt)
        self.step_pred = step_predictor
        self.kv_block_size = kv_block_size
        self.prefix_share = prefix_share   # pool created in share mode:
                                           # free() decrements refcounts and
                                           # parks trie-registered blocks in
                                           # the LRU cache instead of eagerly
                                           # freeing
        self.kv_max_blocks = kv_max_blocks  # admission-growth cap (0 = un-
                                            # bounded): a leak then surfaces
                                            # as declined admissions
        # batch-size buckets: padded shapes the batched step may see
        self._b_buckets = sorted(
            {min(b, self.decode_max_batch) for b in batch_buckets if b >= 1}
            | {self.decode_max_batch})
        # (B bucket, width, positions per row) shapes run
        self._shapes: Set[Tuple[int, int, int]] = set()
        self._tbt_ema = 0.0             # fallback t_step estimate (no prior)
        self._waiting: List[DecodeJob] = []
        self._resident: Dict[int, DecodeJob] = {}   # rid -> job (slots)
        self._admitting = 0             # jobs mid-ingestion: in NEITHER list
        self._in_pool: set = set()      # rids whose KV lives in self.kv
        self.kv: Optional[PagedKVCache] = None      # lazily sized on first use
        # serializes ALL self.kv access: the worker's per-step gather/scatter
        # runs outside _cv, while take() extracts evicted streams from other
        # threads. Lock order: _cv -> _kv_lock.
        self._kv_lock = threading.Lock()
        self._cv = threading.Condition()
        self._order = 0
        self._shutdown = False
        self.finished: List[Request] = []
        self.outputs: Dict[int, List[int]] = {}
        self.tbt_samples: List[float] = []   # per-ACCEPTED-token TBT: a step
                                             # committing a tokens appends a
                                             # samples of dt/a
        self.step_samples: List[float] = []  # per-step wall latency
        self.preemptions = 0
        self.steps = 0                  # batched decode steps executed
        self.row_steps = 0              # (stream, step) pairs: per-row
                                        # tokens/step = len(tbt_samples)/this
        # --- speculative decoding (inert with spec_decode=False) ----------
        self.spec_decode = spec_decode
        # drafts must fit the 1-block scratch sequence (span writes at
        # positions 0..draft_k) and leave room for the verified token
        self.draft_k = max(1, min(int(draft_k), kv_block_size - 1))
        self.draft_fn = draft_fn        # None = self-drafting n-gram drafter
        self.spec_probe_period = max(int(spec_probe_period), 1)
        self.spec_throttle = float(spec_throttle)
        self.spec_steps = 0             # steps that ran the k+1 verify shape
        self.draft_proposed = 0         # draft tokens sent to verification
        self.draft_accepted = 0         # draft tokens committed
        self._accept_tps = 0.0          # aggregate tokens/step EMA fallback
                                        # (no step_pred attached)
        # supervised-worker health: a worker exception strands queued +
        # resident jobs' REQUESTS back to `on_fault` (the Proxy re-runs them
        # from prefill — their pool KV died with the instance) and flips
        # healthy until restart().
        self.healthy = True
        self.on_fault: Optional[Callable] = None   # (requests, exc) -> None
        self.last_error: Optional[BaseException] = None
        self.last_progress = clock()
        self._inject: Optional[object] = None      # chaos: raise in worker
        # incarnation counter, bumped at every strand: a worker that wakes
        # from a hang AFTER restart() sees healthy=True again, so the flag
        # alone cannot tell it its job was re-dispatched — the epoch can
        self._epoch = 0
        # the verify pass is a batched ragged step, so spec_decode routes to
        # the batched worker even at slot cap 1
        run = self._run_batched \
            if self.decode_max_batch > 1 or self.spec_decode else self._run
        self._thread = threading.Thread(target=lambda: self._supervised(run),
                                        daemon=True, name="decode-instance")
        self._thread.start()

    # ------------------------------------------------------------- frontend
    def submit(self, job: DecodeJob) -> None:
        """Enqueue a decode job (fresh handoff or a migrated-in stream)."""
        req = job.request
        if req.decode_start is None:
            now = self.clock()
            job.enqueued = now
            req.decode_start = now      # fixes Request.decode_deadline
            if req.output_tokens <= 0:
                req.output_tokens = self.decode_tokens
        if job.target <= 0:
            # deadline (output_tokens x tbt_slo) and remaining work must
            # count the SAME tokens, or slack estimates skew by their ratio
            job.target = req.output_tokens if req.output_tokens > 0 \
                else self.decode_tokens
        with self._cv:
            job.order = self._order
            self._order += 1
            self._waiting.append(job)
            self._cv.notify_all()

    def pending(self) -> int:
        """Decode jobs waiting in this instance's queue."""
        with self._cv:
            return len(self._waiting)

    def resident(self) -> int:
        """Streams currently occupying batch slots."""
        with self._cv:
            return len(self._resident)

    def idle(self) -> bool:
        """No queued work and nothing decoding. An unhealthy instance is
        never idle (its victims are mid-flight to the recovery path)."""
        with self._cv:
            return self.healthy and not self._waiting \
                and not self._resident and self._admitting == 0

    def compile_cache_size(self) -> int:
        """Distinct (batch bucket, KV width, positions per row) shapes the
        batched steps have run — the count the shape buckets bound: at most
        |B buckets| x |KV widths| per family, the plain S = 1 step and,
        under spec_decode, the S = draft_k + 1 verify step."""
        return len(self._shapes)

    # ------------------------------------------------- migration (the Proxy)
    def snapshot_load(self, instance_id: int,
                      step_time: Callable[[int, float], float]) -> DecodeLoad:
        """Planner view of this instance: the real slot cap plus the
        admission queue."""
        with self._cv:
            jobs = list(self._waiting)
            res = list(self._resident.values())
        ctx = sum(j.request.num_tokens + j.tokens_done for j in jobs) \
            + sum(j.request.num_tokens + j.tokens_done for j in res)
        if self.spec_decode:
            # migration gating prices per-ACCEPTED-token time: a step here
            # commits E[tokens/step] tokens
            e = self._e_tokens()
            if e > 1.0:
                raw = step_time
                step_time = lambda b, c, _f=raw, _e=e: _f(b, c) / _e  # noqa: E731
        return DecodeLoad(instance_id=instance_id,
                          n_resident=len(res),
                          n_waiting=len(jobs), ctx_tokens=float(ctx),
                          max_batch=self.decode_max_batch,
                          step_time=step_time)

    def snapshot_candidates(self) -> List[DecodeCandidate]:
        """Queued (not resident) jobs as migration candidates."""
        with self._cv:
            jobs = list(self._waiting)
        return [DecodeCandidate(
            key=j.request.rid,
            context_tokens=float(j.request.num_tokens + j.tokens_done),
            remaining_tokens=float(j.target - j.tokens_done),
            deadline=j.request.decode_deadline,
            migrations=j.request.decode_migrations) for j in jobs]

    def take(self, rids: Sequence[int]) -> List[DecodeJob]:
        """Remove and return queued jobs by request id (migration departure).
        An EVICTED stream whose KV still lives in the paged pool is gathered
        back into a dense handoff cache first."""
        want = set(rids)
        with self._cv:
            taken = [j for j in self._waiting if j.request.rid in want]
            self._waiting = [j for j in self._waiting
                             if j.request.rid not in want]
        for job in taken:
            if job.request.rid in self._in_pool:
                self._extract_cache(job)
            job.private = False         # the receiver adopts it anew
        return taken

    # ------------------------------------------------------------ lifecycle
    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        self._thread.join(10.0)

    # ------------------------------------------------ supervised recovery
    def _supervised(self, loop: Callable[[], None]) -> None:
        """Worker wrapper: exceptions strand the instance instead of
        silently killing the thread; the thread survives for restart()."""
        with on_stream(self.stream):
            while True:
                try:
                    loop()
                    return                  # clean shutdown exit
                except Exception as exc:
                    self._on_worker_failure(exc)

    def _check_inject(self) -> None:
        """Chaos hook, called at the token boundary: raise a pending
        injected fault, or stall for a simulated hang."""
        inj = self._inject
        if inj is None:
            return
        self._inject = None
        if isinstance(inj, tuple) and inj and inj[0] == "hang":
            time.sleep(float(inj[1]))
            return
        raise inj if isinstance(inj, BaseException) \
            else RuntimeError(str(inj))

    def inject_fault(self, fault) -> None:
        with self._cv:
            self._inject = fault
            self._cv.notify_all()

    def _on_worker_failure(self, exc: Exception) -> None:
        """Idempotent strand: queued + resident jobs' requests return to
        `on_fault`; the paged pool is considered dead."""
        with self._cv:
            if not self.healthy:
                return
            self.healthy = False
            self.last_error = exc
            self._epoch += 1
            victims = [j.request for j in self._resident.values()]
            victims += [j.request for j in self._waiting]
            self._resident.clear()
            self._waiting = []
            self._admitting = 0
            with self._kv_lock:
                self.kv = None              # pool died with the worker
            self._in_pool.clear()
            self._cv.notify_all()
        cb = self.on_fault
        if cb is not None:
            cb(victims, exc)                # outside _cv: Proxy re-enters

    def restart(self) -> None:
        with self._cv:
            self.healthy = True
            self.last_error = None
            self.last_progress = self.clock()
            self._cv.notify_all()

    @property
    def progress_ts(self) -> float:
        return self.last_progress

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until the instance is idle (condition variable notified on
        every completion)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._waiting and not self._resident
                and self._admitting == 0, timeout)

    # -------------------------------------------------------------- shared
    def _sync(self) -> None:
        """Wait for this instance's queued device work: a clock read after
        it times the work, not its enqueue."""
        if self.stream is not None:
            self.stream.synchronize()

    def _adopt(self, cache: Dict) -> Dict:
        """Take a handed-over cache onto this instance's stream: wait for
        the producer's work (the event the handoff carries) and tell the
        caching allocator the tensors are read on this stream. Returns the
        cache without the event."""
        ready = cache.get("ready")
        if self.stream is not None:
            if ready is not None:
                self.stream.wait_event(ready)
            cache["k"].record_stream(self.stream)
            cache["v"].record_stream(self.stream)
        return {key: val for key, val in cache.items() if key != "ready"}

    def _t_step(self, b: int, ctx: float) -> float:
        if self.step_pred is not None:
            return self.step_pred.step_time(b, ctx)
        return self._tbt_ema

    def _e_tokens(self, key: Optional[int] = None) -> float:
        """E[tokens committed per step] for S-EDF and migration pricing: the
        per-stream accept EMA when `key` has history, else the aggregate;
        exactly 1.0 with speculation off."""
        if not self.spec_decode:
            return 1.0
        if self.step_pred is not None:
            return self.step_pred.expected_tokens_per_step(key)
        return self._accept_tps if self._accept_tps > 0.0 else 1.0

    def _t_token(self, b: int, ctx: float,
                 key: Optional[int] = None) -> float:
        """Per-ACCEPTED-token service time: raw step time over expected
        tokens per step. Identical to `_t_step` without speculation."""
        return self._t_step(b, ctx) / self._e_tokens(key)

    def _observe_accept(self, rid: int, advance: int) -> None:
        """Record that one step committed `advance` tokens for stream rid."""
        if self.step_pred is not None:
            self.step_pred.observe_accept(rid, advance)
        a = 0.25 if self._accept_tps > 0.0 else 1.0
        self._accept_tps += a * (advance - self._accept_tps)

    def _entry(self, job: DecodeJob) -> DecodeEntry:
        return DecodeEntry(key=job.request.rid,
                           remaining_tokens=float(
                               job.target - job.tokens_done),
                           deadline=job.request.decode_deadline,
                           order=job.order)

    def _observe(self, b: int, ctx: float, tbt: float) -> None:
        a = 0.1 if self._tbt_ema > 0 else 1.0
        self._tbt_ema += a * (tbt - self._tbt_ema)
        if self.step_pred is not None:
            self.step_pred.observe(b, ctx, tbt)

    def _emit(self, job: DecodeJob, tokens: Sequence[int]) -> None:
        """Append decoded tokens to the job's output record."""
        if job.output is None:
            job.output = [job.first_token]
        job.output.extend(tokens)
        job.next_token = tokens[-1]

    def _finish(self, job: DecodeJob, now: float) -> None:
        job.request.finish_time = now
        job.request.mean_tpot = (now - job.enqueued) / max(job.target, 1)
        self.outputs[job.request.rid] = list(job.output or [job.first_token])
        self.finished.append(job.request)

    # ------------------------------------- single-stream worker (slot cap 1)
    def _pick_next_locked(self, now: float) -> DecodeJob:
        # caller holds _cv; _waiting is non-empty
        if len(self._waiting) == 1:
            return self._waiting.pop(0)
        ctx = sum(j.request.num_tokens + j.tokens_done
                  for j in self._waiting) / len(self._waiting)
        ranked = self.sched.rank([self._entry(j) for j in self._waiting],
                                 now, self._t_token(1, ctx))
        best = ranked[0].key
        for i, j in enumerate(self._waiting):
            if j.request.rid == best:
                return self._waiting.pop(i)
        return self._waiting.pop(0)       # unreachable; defensive

    def _should_yield(self, job: DecodeJob, now: float) -> bool:
        """Token-boundary preemption check: a strictly-higher-priority queued
        job displaces the running one."""
        if not (self.sched.policy == "s-edf" and self.sched.preempt):
            return False
        with self._cv:
            if not self._waiting:
                return False
            queued = list(self._waiting)
        ctx = job.request.num_tokens + job.tokens_done
        t_step = self._t_token(1, float(ctx), job.request.rid)
        own = self.sched.priority(self._entry(job), now, t_step)
        best = max(self.sched.priority(self._entry(j), now, t_step)
                   for j in queued)
        return best > own

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._waiting and not self._shutdown \
                        and self._inject is None:
                    self._cv.wait(0.1)
                if not self._waiting and self._inject is None:
                    return                     # shutdown with an empty queue
            self._check_inject()
            with self._cv:
                if not self._waiting:
                    continue
                job = self._pick_next_locked(self.clock())
                self._resident[job.request.rid] = job
                epoch = self._epoch
            if not job.private:
                # decode_step writes in place: work on a copy of our own
                c = self._adopt(job.cache)
                job.cache = {"k": c["k"].clone(), "v": c["v"].clone(),
                             "pos": int(c["pos"])}
                job.private = True
            start = job.first_token if job.next_token is None \
                else job.next_token
            tok = torch.tensor([start], dtype=torch.int64, device=self.device)
            cache = job.cache
            last = self.clock()
            while job.tokens_done < job.target:
                logits, cache = decode_step(self.params, self.cfg, tok, cache)
                tok = logits.argmax(-1)
                nxt = int(tok[0])              # waits for the step
                now = self.clock()
                self.tbt_samples.append(now - last)
                self.step_samples.append(now - last)
                self.row_steps += 1
                self._observe(
                    1, float(job.request.num_tokens + job.tokens_done),
                    now - last)
                last = now
                self.last_progress = now
                job.tokens_done += 1
                job.cache = cache
                self._emit(job, [nxt])
                self._check_inject()           # chaos: token-boundary fault
                if self._epoch != epoch:
                    # stranded mid-decode and already re-dispatched:
                    # finishing it here would complete the request twice
                    break
                if job.tokens_done < job.target and \
                        self._should_yield(job, now):
                    job.request.decode_preemptions += 1
                    self.preemptions += 1
                    with self._cv:
                        self._waiting.append(job)
                        self._resident.pop(job.request.rid, None)
                        self._cv.notify_all()
                    break
            else:
                self._finish(job, self.clock())
                with self._cv:
                    self._resident.pop(job.request.rid, None)
                    self._cv.notify_all()

    # --------------------------------- continuous-batching worker (slots > 1)
    def _ensure_pool_locked(self, k: torch.Tensor, need_blocks: int) -> None:
        """Create the paged pool on first admission (sized for 2x the slot
        cap at this stream's footprint)."""
        L_, K, hd = k.shape[0], k.shape[-2], k.shape[-1]
        if self.kv is None:
            blocks = max((2 * self.decode_max_batch + 1) * need_blocks + 1, 8)
            self.kv = PagedKVCache(L_, blocks, self.kv_block_size, K, hd,
                                   dtype=k.dtype, device=self.device,
                                   prefix_share=self.prefix_share,
                                   max_blocks=self.kv_max_blocks,
                                   stream=self.stream)
            # scratch sequence: the slot padding rows of the batched step
            # write into / gather from (never read through a kv_len mask)
            self.kv.allocate(_SCRATCH_SEQ, 1)

    def _ingest(self, job: DecodeJob, force: bool = False) -> bool:
        """Move a stream's KV into the paged pool (no-op for an evicted
        stream whose blocks stayed resident). False = pool cannot hold it
        right now; the job goes back to the queue. ``force`` grows the pool
        instead of declining (the no-resident deadlock guard)."""
        rid = job.request.rid
        if rid in self._in_pool:
            return True
        cache = self._adopt(job.cache)
        pos = int(cache["pos"])
        remaining = job.target - job.tokens_done
        need_tokens = pos + max(remaining, 1)
        if self.spec_decode:
            # draft headroom: a verify step writes the FULL k+1 span even
            # when only part of it commits, so the last step may touch
            # positions up to final_len + draft_k
            need_tokens += self.draft_k
        need_blocks = (need_tokens + self.kv_block_size - 1) \
            // self.kv_block_size
        with self._kv_lock:
            self._ensure_pool_locked(cache["k"], need_blocks)
            if not self.kv.can_allocate(need_tokens):
                # stay queued only if the pool COULD fit this stream once
                # residents complete; grow for a larger footprint now
                can_ever_fit = need_blocks <= self.kv.num_blocks - 1
                if can_ever_fit and self._in_pool and not force:
                    return False
                try:
                    self.kv.grow_for(need_blocks)
                except MemoryError:
                    if not force:
                        return False    # cap reached: stream stays queued
                    # the no-resident deadlock guard must make progress
                    self.kv.grow(max(need_blocks, self.kv.num_blocks))
            self.kv.allocate(rid, need_tokens)
            self.kv.write_prompt(rid, cache["k"][:, 0, :pos],
                                 cache["v"][:, 0, :pos])
        # a migrated-in mid-stream job has tokens_done > 0 inside pos
        job.base_len = pos - job.tokens_done
        job.cache = None                # the pool is now authoritative
        self._in_pool.add(rid)
        return True

    def _extract_cache(self, job: DecodeJob) -> None:
        """Gather an evicted stream's KV out of the pool back into the dense
        handoff-cache format (migration departure), padded to cover the
        REMAINING decode so a slot-cap-1 receiver never runs off the cache."""
        rid = job.request.rid
        with on_stream(self.stream), self._kv_lock:
            k, v, length = self.kv.gather(rid)
            self._sync()                # copied out before the next write
            self.kv.free(rid)
            kv_len = job.base_len + job.tokens_done
            need = kv_len + max(job.target - job.tokens_done, 0) + 1
            keep = max(kv_len, int(length))
            k, v = k[:, None, :keep], v[:, None, :keep]
            if keep < need:
                pad = list(k.shape)
                pad[2] = need - keep
                k = torch.cat([k, k.new_zeros(pad)], dim=2)
                v = torch.cat([v, v.new_zeros(pad)], dim=2)
            self._sync()
        job.cache = {"k": k, "v": v, "pos": kv_len}
        self._in_pool.discard(rid)

    def _plan_locked(self, now: float) -> List[DecodeJob]:
        """Token-boundary admission + eviction DECISIONS (caller holds _cv):
        one `select_batch` over residents + waiting picks the new resident
        set. Pool-resident streams (evicted earlier) are admitted in place;
        NEW streams are returned for the caller to ingest outside _cv."""
        everyone: Dict[int, DecodeJob] = dict(self._resident)
        for j in self._waiting:
            everyone[j.request.rid] = j
        if not everyone:
            return []
        total = len(everyone)
        b_eff = min(self.decode_max_batch, total)
        ctx = sum(j.request.num_tokens + j.tokens_done
                  for j in everyone.values())
        # per-accepted-token pricing: S-EDF slack compares deadline headroom
        # against remaining_tokens * t, so t is time per COMMITTED token
        t_step = self._t_token(b_eff, ctx / total)
        entries = [self._entry(j) for j in everyone.values()]
        batch, preempted = self.sched.select_batch(
            entries, set(self._resident), self.decode_max_batch, now, t_step)
        for rid in preempted:
            # slot eviction: progress, pool blocks, and next token all kept
            job = self._resident.pop(rid)
            job.request.decode_preemptions += 1
            self.preemptions += 1
            self._waiting.append(job)
        to_ingest: List[DecodeJob] = []
        claimed = set()
        for rid in batch:
            if rid in self._resident:
                continue
            job = everyone[rid]
            claimed.add(rid)
            if rid in self._in_pool:
                self._resident[rid] = job          # re-admission is free
            else:
                self._admitting += 1
                to_ingest.append(job)
        if claimed:
            self._waiting = [j for j in self._waiting
                             if j.request.rid not in claimed]
        return to_ingest

    def _bucket(self, n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if b >= n:
                return b
        return buckets[-1]

    def _width_locked(self, jobs: List[DecodeJob]) -> int:
        """KV width bucket: a power of two over the widest row's ALLOCATED
        block count (gather_batch pads to at least the table width)."""
        need_blocks = max(
            (len(self.kv.table(j.request.rid).blocks) for j in jobs),
            default=1)
        width = 1
        while width < need_blocks:
            width *= 2
        return width

    def _step_batch(self, jobs: List[DecodeJob]) -> None:
        """One decode step over the whole resident batch: gather the
        resident KV views, run `decode_step_ragged` at the padded bucket
        shape, scatter the new K/V back in one batched write."""
        n = len(jobs)
        bb = self._bucket(n, self._b_buckets)
        seq_ids = [j.request.rid for j in jobs] + \
            [_SCRATCH_SEQ] * (bb - n)
        kv_lens = np.zeros(bb, np.int64)
        tokens = np.zeros(bb, np.int64)
        for i, j in enumerate(jobs):
            kv_lens[i] = j.base_len + j.tokens_done
            tokens[i] = j.first_token if j.next_token is None else j.next_token
        t0 = self.clock()
        with self._kv_lock:
            width = self._width_locked(jobs)
            self._shapes.add((bb, width, 1))
            k_g, v_g, _ = self.kv.gather_batch(seq_ids, width)
            logits, k_new, v_new = decode_step_ragged(
                self.params, self.cfg,
                torch.as_tensor(tokens, device=self.device), k_g, v_g,
                torch.as_tensor(kv_lens, device=self.device))
            next_tokens = logits.argmax(-1).tolist()
            self.kv.write_tokens(seq_ids, kv_lens.tolist(), k_new, v_new)
            self._sync()
        # the next token cannot start before the scatter completes: stamp the
        # step after write_tokens has run on the card
        now = self.clock()
        self.steps += 1
        self.last_progress = now
        dt = now - t0
        self.step_samples.append(dt)
        self._observe(n, float(kv_lens[:n].mean()), dt)
        done: List[DecodeJob] = []
        self.row_steps += len(jobs)
        for i, j in enumerate(jobs):
            self.tbt_samples.append(dt)
            j.tokens_done += 1
            self._emit(j, [int(next_tokens[i])])
            if self.spec_decode:
                # drafter corpus and accept surface stay current through the
                # plain-step fallback, or throttled streams would never see
                # their tokens/step settle to 1
                if j.history is None:
                    j.history = [int(tokens[i])]
                j.history.append(j.next_token)
                del j.history[:-_SPEC_HISTORY_CAP]
                self._observe_accept(j.request.rid, 1)
            if j.tokens_done >= j.target:
                done.append(j)
        self._retire_done(done, now)

    def _retire_done(self, done: List[DecodeJob], now: float) -> None:
        """Finish completed streams and release their pool blocks."""
        if not done:
            return
        with self._cv:
            for j in done:
                rid = j.request.rid
                if rid not in self._resident:
                    # stranded mid-step (watchdog fired): the request was
                    # re-dispatched — finishing it here would complete twice
                    continue
                self._finish(j, now)
                self._resident.pop(rid, None)
                with self._kv_lock:
                    # a refcount DECREMENT, not an eager free, on a
                    # prefix-sharing pool: blocks other streams still
                    # reference stay live
                    if self.kv is not None:
                        self.kv.free(rid)
                self._in_pool.discard(rid)
                if self.step_pred is not None and self.spec_decode:
                    self.step_pred.forget_stream(rid)
            self._cv.notify_all()

    # -------------------------------------- speculative draft -> verify step
    def _draft_for(self, job: DecodeJob) -> List[int]:
        """Propose this step's draft for one stream (possibly empty).

        Adaptive throttle: when the stream's observed tokens/step EMA sits
        below `spec_throttle`, verification costs more than the committed
        tokens repay — draft nothing (the step then runs at plain shape) and
        re-probe every `spec_probe_period` steps."""
        k = min(self.draft_k, job.target - job.tokens_done - 1)
        if k <= 0:
            return []
        rid = job.request.rid
        if self._e_tokens(rid) < self.spec_throttle:
            job.probe_in -= 1
            if job.probe_in > 0:
                return []
            job.probe_in = self.spec_probe_period
        if self.draft_fn is not None:
            d = [int(t) for t in self.draft_fn(rid, job.history, k)][:k]
        else:
            d = _ngram_draft(job.history, k)[:k]
        self.draft_proposed += len(d)
        return d

    def _spec_step_batch(self, jobs: List[DecodeJob]) -> None:
        """One speculative decode step: draft per row, ONE k+1-wide verify
        pass (`decode_verify_ragged`) over the batch, greedy acceptance,
        multi-token commit with rejected-KV rollback by length. When EVERY
        row drafts nothing the step is the plain `_step_batch`."""
        for j in jobs:
            if j.history is None:
                j.history = [j.first_token if j.next_token is None
                             else j.next_token]
        drafts = [self._draft_for(j) for j in jobs]
        if not any(drafts):
            self._step_batch(jobs)
            return
        n = len(jobs)
        S = self.draft_k + 1
        bb = self._bucket(n, self._b_buckets)
        seq_ids = [j.request.rid for j in jobs] + [_SCRATCH_SEQ] * (bb - n)
        kv_lens = np.zeros(bb, np.int64)
        tokens = np.zeros((bb, S), np.int64)
        for i, (j, d) in enumerate(zip(jobs, drafts)):
            kv_lens[i] = j.base_len + j.tokens_done
            tokens[i, 0] = j.first_token if j.next_token is None \
                else j.next_token
            # short or empty drafts leave zeros in the tail columns: the
            # acceptance scan below stops at len(d), so they never commit
            tokens[i, 1:1 + len(d)] = d
        t0 = self.clock()
        with self._kv_lock:
            # extend each row's table to cover the FULL span the verify step
            # writes (kv_len + S) BEFORE gathering: the gathered width must
            # hold the draft positions, since an in-place index assignment
            # out of range raises (ingestion already reserves draft_k
            # headroom; this keeps a migrated-in table safe)
            for i, j in enumerate(jobs):
                rid = j.request.rid
                need = int(kv_lens[i]) + S
                table = self.kv.table(rid)
                if len(table.blocks) * self.kv_block_size < need:
                    self.kv.extend(rid, need - table.length)
            width = self._width_locked(jobs)
            self._shapes.add((bb, width, S))
            k_g, v_g, _ = self.kv.gather_batch(seq_ids, width)
            logits, k_new, v_new = decode_verify_ragged(
                self.params, self.cfg,
                torch.as_tensor(tokens, device=self.device), k_g, v_g,
                torch.as_tensor(kv_lens, device=self.device))
            greedy = logits.argmax(-1).tolist()             # (bb, S)
            # commit the longest draft prefix matching the argmax chain,
            # plus the one token the verify pass proves
            counts = [0] * bb              # scratch rows commit nothing
            advances = [1] * n
            for i, (j, d) in enumerate(zip(jobs, drafts)):
                a = 0
                while a < len(d) and d[a] == greedy[i][a]:
                    a += 1
                advances[i] = min(a + 1, j.target - j.tokens_done)
                counts[i] = advances[i]
            self.kv.write_token_span(seq_ids, kv_lens.tolist(), counts,
                                     k_new, v_new)
            self._sync()
        now = self.clock()
        self.steps += 1
        self.spec_steps += 1
        self.last_progress = now
        dt = now - t0
        self.step_samples.append(dt)
        self._observe(n, float(kv_lens[:n].mean()), dt)
        done: List[DecodeJob] = []
        self.row_steps += n
        for i, j in enumerate(jobs):
            adv = advances[i]
            emitted = greedy[i][:adv]
            self._emit(j, emitted)
            j.history.extend(emitted)
            del j.history[:-_SPEC_HISTORY_CAP]
            j.tokens_done += adv
            self.draft_accepted += adv - 1
            self._observe_accept(j.request.rid, adv)
            # one TBT sample per committed token, so TBT percentiles stay
            # meaningful at tokens/step > 1
            self.tbt_samples.extend([dt / adv] * adv)
            if j.tokens_done >= j.target:
                done.append(j)
        self._retire_done(done, now)

    def _run_batched(self) -> None:
        while True:
            with self._cv:
                while not self._waiting and not self._resident \
                        and not self._shutdown and self._inject is None:
                    self._cv.wait(0.1)
                if self._shutdown and not self._waiting \
                        and not self._resident:
                    return
            self._check_inject()
            with self._cv:
                to_ingest = self._plan_locked(self.clock())
            for job in to_ingest:                  # device I/O: no _cv held
                ok = self._ingest(job)
                with self._cv:
                    self._admitting -= 1
                    if ok:
                        self._resident[job.request.rid] = job
                    else:
                        self._waiting.append(job)
            with self._cv:
                force_job = None
                if not self._resident and self._waiting:
                    # deadlock guard: nothing is decoding, so no completion
                    # can ever free blocks for the declined admissions above
                    force_job = self._pick_next_locked(self.clock())
                    self._admitting += 1
            if force_job is not None:
                self._ingest(force_job, force=True)
                with self._cv:
                    self._admitting -= 1
                    self._resident[force_job.request.rid] = force_job
            with self._cv:
                batch = sorted(self._resident.values(), key=lambda j: j.order)
            if not batch:
                time.sleep(0.001)
                continue
            if self.spec_decode:
                self._spec_step_batch(batch)
            else:
                self._step_batch(batch)


def profile_step_times(params, cfg, *, batch_sizes: Sequence[int] = (1, 2, 4, 8),
                       ctx: int = 256, decode_tokens: int = 16,
                       warmup: int = 2, kv_block_size: int = 128,
                       clock: Callable[[], float] = time.monotonic,
                       ) -> List[Tuple[int, float, float]]:
    """Measure the REAL batched decode step over a sweep of batch sizes.

    Drives `decode_step_ragged` + a bf16 `PagedKVCache` directly (no
    threads), on the device of `params`: for each B, B synthetic streams
    with `ctx` prompt tokens decode `decode_tokens` tokens; the MEDIAN
    per-step wall time after `warmup` steps is recorded (robust to host
    scheduler jitter — one descheduling would dominate a mean). A step is
    timed from its gather to the end of its scatter on the device, as
    `DecodeInstance._step_batch` times it. The prompts' K/V and the first
    tokens are drawn from a CPU generator seeded 0. Returns
    ``[(B, mean_context, seconds_per_step)]`` — the samples
    `DecodeStepPredictor.from_profile` fits its measured step-time prior
    from. Counterpart of the reference's function of the same name."""
    generator = torch.Generator().manual_seed(0)
    device = params["embed"].device
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L_ = cfg.num_layers

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    samples: List[Tuple[int, float, float]] = []
    for bsz in batch_sizes:
        tokens_cap = ctx + decode_tokens + warmup + 1
        blocks_per = (tokens_cap + kv_block_size - 1) // kv_block_size
        kv = PagedKVCache(L_, bsz * blocks_per + 1, kv_block_size, K, hd,
                          dtype=torch.bfloat16, device=device)
        for s in range(bsz):
            kv.allocate(s, tokens_cap)
            kprompt = torch.randn((L_, ctx, K, hd), generator=generator)
            vprompt = torch.randn((L_, ctx, K, hd), generator=generator)
            kv.write_prompt(s, kprompt.to(device), vprompt.to(device))
        width = 1
        while width * kv_block_size < tokens_cap:
            width *= 2
        seq_ids = list(range(bsz))
        toks = torch.randint(0, cfg.vocab_size, (bsz,), generator=generator)
        toks = toks.to(device)
        lens = np.full(bsz, ctx, np.int64)
        elapsed: List[float] = []
        ctx_timed: List[float] = []
        sync()
        for it in range(decode_tokens + warmup):
            t0 = clock()
            k_g, v_g, _ = kv.gather_batch(seq_ids, width)
            logits, k_new, v_new = decode_step_ragged(
                params, cfg, toks, k_g, v_g,
                torch.as_tensor(lens, device=device))
            toks = logits.argmax(-1)
            kv.write_tokens(seq_ids, lens.tolist(), k_new, v_new)
            sync()
            t1 = clock()
            if it >= warmup:
                elapsed.append(t1 - t0)
                ctx_timed.append(float(lens.mean()))   # ctx the step RAN at
            lens += 1
        samples.append((bsz, float(np.mean(ctx_timed)),
                        float(np.median(elapsed))))
    return samples
