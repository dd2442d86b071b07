"""Hybrid (colocated prefill + decode) serving instance.

One worker thread drives token-budget rounds planned by
`HybridSchedulerCore`: every round packs the resident decode batch (one
token per stream) plus S-EDF-ranked prefill chunk slices onto the SAME
device, against the SAME prefix-sharing `PagedKVCache`. The two phases share
blocks end-to-end, so a locally-decoded stream never pays a PD handoff: at
prefill completion the prompt KV is scattered into the pool blocks the
request already holds and the stream simply joins the resident decode batch
(zero copies, no dense-cache transfer).

Within a round, prefill advances ONE OPERATOR SEGMENT at a time
(`SegmentedPrefill.step`) and batched decode steps are WOVEN between
segments at an SLO-derived cadence (``cadence_margin x`` the tightest
resident TBT SLO): the colocation payoff of operator-level interruption — a
whole 512-token chunk costs many multiples of a decode SLO, but a single
operator segment costs ~1 ms, so decode tokens keep flowing while the chunk
computes.

Preemption falls out of admission, as in the standalone engines: a prefill
not sliced this round keeps its device-resident task (the operator cursor is
untouched — it resumes at its exact operator offset), and a decode stream
squeezed out keeps its pool blocks and next token.

Counterpart of src/repro/serving/hybrid_instance.py. On the card the
instance owns one CUDA stream: prefill segments, woven decode steps (the
split-KV decode kernel through `kernels.ops`) and every read, write and
growth of the pool run on it. Where the reference relied on JAX's buffers
and synchronous dispatch, the port differs, and says so at the site: the
host's run-ahead of queued segments is bounded so a weave fires at the
device's operator boundary, a handoff carries a gathered buffer and an
event, and a stranded request gives back its pool blocks.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.predictor import (DecodeStepPredictor,
                                        OnlineTTFTPredictor, TTFTPredictor)
from repro_torch.core.prefixcache import block_keys
from repro_torch.core.request import Request, RequestState
from repro_torch.core.scheduler import (DecodeEntry, DecodeSchedulerCore,
                                        HybridSchedulerCore, SchedulerCore)
from repro_torch.models.model import decode_step_ragged, supports_ragged_decode
from repro_torch.models.segments import (PrefillTask, SegmentedPrefill, mark,
                                         on_stream, stream_for, wait)
from repro_torch.serving.decode_instance import DecodeJob
from repro_torch.serving.kvcache import PagedKVCache

# pool slot the batched decode step's padding rows write into / gather from
_SCRATCH_SEQ = -1

# segments the host may queue ahead of the device before a weave check:
# `ExecutionPool`'s default dispatch depth
_WEAVE_DEPTH = 2


class _Stranded(Exception):
    """The round's requests were stranded (and may be re-dispatched) while
    the worker ran it: the worker drops the round without touching the
    pool blocks those requests held."""


@dataclass
class _Prefill:
    """A request in its prefill phase. ``done_tokens`` is the scheduler's
    resume offset; the device-resident `PrefillTask` (created lazily at the
    first admitted slice) holds the matching operator cursor."""
    request: Request
    tokens: np.ndarray
    task: Optional[PrefillTask] = None
    done_tokens: int = 0
    keys: Tuple[int, ...] = ()
    hit: int = 0                        # pinned prefix tokens (capped n-1)
    allocated: bool = False             # pool blocks reserved at arrival
    started: float = 0.0                # first slice (predictor refit pair)
    ticket: Optional[object] = None     # in-flight tier PromotionTicket


@dataclass
class HybridJob:
    """A locally-decoding stream whose KV lives in the SHARED pool from
    birth — the prefill wrote it there, so there is nothing to ingest."""
    request: Request
    first_token: int
    tokens_done: int = 0
    next_token: Optional[int] = None
    enqueued: float = 0.0
    order: int = 0
    target: int = 0
    base_len: int = 0                   # prompt tokens (kv pos = base + done)
    last_emit: float = 0.0              # previous token's wall-clock (TBT)
    # full emitted trajectory ([first_token] + every decoded token) — the
    # parity handle tests compare against the standalone engines
    emitted: List[int] = field(default_factory=list)


class HybridInstance:
    """Colocated runtime: `HybridSchedulerCore` plans each round, the worker
    executes it as woven operator segments + batched decode steps. Runs on
    the device of the executor's params."""

    def __init__(self, params, cfg, *, max_seq: int,
                 clock: Callable[[], float] = time.monotonic,
                 token_budget: int = 4096,
                 chunk_tokens: int = 512,
                 decode_max_batch: int = 8,
                 policy: str = "s-edf",
                 decode_policy: str = "s-edf",
                 decode_preempt: Optional[bool] = None,
                 predictor: Optional[TTFTPredictor] = None,
                 step_predictor: Optional[DecodeStepPredictor] = None,
                 decode_tokens: int = 8,
                 decode_cadence: float = 0.0,
                 cadence_margin: float = 0.8,
                 granularity: str = "op",
                 batch_buckets: Sequence[int] = (1, 2, 4, 8),
                 kv_block_size: int = 128,
                 kv_pool_blocks: int = 512,
                 kv_max_blocks: int = 0,
                 host_cache_blocks: int = 0,
                 disk_cache_blocks: int = 0,
                 promote_wait_s: float = 10.0,
                 prefix_share: bool = True,
                 executor: Optional[SegmentedPrefill] = None,
                 on_decode_ready: Optional[Callable[[DecodeJob], None]]
                 = None):
        if not supports_ragged_decode(cfg):
            raise ValueError(f"hybrid decode needs the batched ragged step, "
                             f"unsupported for family {cfg.family!r}")
        if decode_max_batch < 1:
            raise ValueError("decode_max_batch must be >= 1")
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1 (the weave quantum)")
        self.params = params
        self.cfg = cfg
        self.clock = clock
        self.max_seq = max_seq
        self.decode_tokens = decode_tokens
        self.decode_max_batch = decode_max_batch
        # 0.0 = derive per round from the tightest resident TBT SLO
        self.decode_cadence = decode_cadence
        self.cadence_margin = cadence_margin
        self.kv_block_size = kv_block_size
        self.step_pred = step_predictor
        # mixed-pool offload: when set, completed prefills are handed off as
        # dense-cache DecodeJobs (the PD path) instead of joining the local
        # batch — a hybrid becomes a weave-free prefill absorber while decode
        # consolidates on dedicated instances
        self.on_decode_ready = on_decode_ready

        if predictor is None and policy != "fcfs":
            # S-EDF needs a TTFT estimate; with no offline profile, start
            # from a mild linear prior and refit online from the prefill
            # latencies this instance itself observes
            predictor = OnlineTTFTPredictor(coeffs=np.array([0.0, 1e-4, 0.0]))
        self.predictor = predictor

        self.core = HybridSchedulerCore(
            prefill=SchedulerCore(predictor=predictor, policy=policy,
                                  enable_batching=False),
            decode=DecodeSchedulerCore(
                policy=decode_policy,
                preempt=(decode_policy == "s-edf") if decode_preempt is None
                else decode_preempt),
            token_budget=token_budget, chunk_tokens=chunk_tokens,
            decode_max_batch=decode_max_batch)
        self.executor = executor or SegmentedPrefill(
            params, cfg, max_seq=max_seq, granularity=granularity,
            chunk_tokens=chunk_tokens)
        self.device = self.executor.device
        self.stream = stream_for(self.device)

        self.prefix_share = prefix_share
        # allocated on the instance's stream, so the caching allocator hands
        # a pool's memory back only to work ordered after its last use there
        with on_stream(self.stream):
            self.kv = PagedKVCache(
                cfg.num_layers, kv_pool_blocks, kv_block_size,
                cfg.num_kv_heads, cfg.resolved_head_dim,
                dtype=self.executor.cache_dtype, device=self.device,
                prefix_share=prefix_share, max_blocks=kv_max_blocks,
                host_cache_blocks=host_cache_blocks,
                disk_cache_blocks=disk_cache_blocks, stream=self.stream)
        self.promote_wait_s = promote_wait_s
        self.kv.allocate(_SCRATCH_SEQ, 1)
        # serializes pool access: the worker's gather/scatter vs. the
        # frontend's arrival-time allocate and the Proxy's probe. Lock
        # order: _cv -> _kv_lock.
        self._kv_lock = threading.Lock()

        self._b_buckets = sorted(
            {min(b, decode_max_batch) for b in batch_buckets if b >= 1}
            | {decode_max_batch})
        # (B bucket, KV width, positions per row) shapes stepped
        self._shapes: Set[Tuple[int, int, int]] = set()

        self._prefills: Dict[int, _Prefill] = {}
        self._jobs: Dict[int, HybridJob] = {}
        self._resident: Set[int] = set()
        self._order = 0
        self._tbt_ema = 0.0
        self._last_decode = clock()
        self._cv = threading.Condition()
        self._shutdown = False

        self.finished: List[Request] = []          # decoded to target
        self.finished_jobs: List[HybridJob] = []   # with emitted trajectories
        self.prefilled: List[Request] = []         # prefill phase completed
        self.tbt_samples: List[float] = []         # true inter-token gaps
        self.rounds = 0                            # hybrid steps planned
        self.steps = 0                             # batched decode steps
        self.preemptions = 0                       # decode slot evictions
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_promotions = 0                 # blocks re-warmed
        self.prefix_promoted_tokens = 0

        # supervised-worker health: same contract as PrefillInstance /
        # DecodeInstance — an exception in the colocated worker strands
        # every in-flight request (both phases) to `on_fault` and flips
        # healthy until restart().
        self.healthy = True
        self.on_fault: Optional[Callable] = None   # (requests, exc) -> None
        self.last_error: Optional[BaseException] = None
        self.last_progress = clock()
        self._inject: Optional[object] = None
        # bumped (under _kv_lock) at every strand; a round that started in an
        # earlier epoch must not touch the pool blocks it planned with
        self._epoch = 0
        self._round_epoch = 0

        self._thread = threading.Thread(target=self._supervised, daemon=True,
                                        name="hybrid-instance")
        self._thread.start()

    # ------------------------------------------------------------- frontend
    def submit(self, req: Request, tokens: np.ndarray) -> None:
        """Enqueue a request for prefill + (by default) local decode. Pool
        blocks for the WHOLE lifetime — prompt plus decode growth — are
        reserved here, so the later phase transition cannot fail."""
        tokens = np.asarray(tokens)
        req.state = RequestState.WAITING
        ps = _Prefill(request=req, tokens=tokens)
        self._acquire(ps)
        with self._cv:
            self._prefills[req.rid] = ps
            self._cv.notify_all()

    def probe_prefix(self, tokens: np.ndarray) -> int:
        """Cached-prefix tokens the shared pool holds for `tokens` (the
        prefix-affinity dispatch signal; same contract as PrefillInstance)."""
        tokens = np.asarray(tokens)
        return self.probe_keys(block_keys(tokens, self.kv_block_size),
                               int(tokens.size))

    def probe_keys(self, keys, num_tokens: int) -> int:
        if not self.prefix_share:
            return 0
        with self._kv_lock:
            hit = self.kv.probe(keys)
        return min(hit, max(num_tokens - 1, 0))

    def probe_keys_tiers(self, keys, num_tokens: int) -> Tuple[int, int, int]:
        """(warm, host, disk) cached tokens for this prompt, jointly capped
        at num_tokens - 1 (same contract as PrefillInstance)."""
        if not self.prefix_share:
            return (0, 0, 0)
        with self._kv_lock:
            warm, host, disk = self.kv.probe_tiers(keys)
        cap = max(num_tokens - 1, 0)
        warm = min(warm, cap)
        host = min(host, cap - warm)
        disk = min(disk, cap - warm - host)
        return warm, host, disk

    def promote_seconds(self, host_tokens: int, disk_tokens: int = 0) -> float:
        if not self.kv.tiered:
            return 0.0
        return self.kv.promote_seconds(host_tokens, disk_tokens)

    def pending(self) -> int:
        with self._cv:
            return len(self._prefills)

    def resident(self) -> int:
        with self._cv:
            return len(self._jobs)

    def idle(self) -> bool:
        with self._cv:
            return not self._prefills and not self._jobs

    def compile_cache_size(self) -> int:
        """Distinct (batch bucket, KV width, positions per row) shapes the
        woven decode steps have run (DecodeInstance's count)."""
        return len(self._shapes)

    def drain(self, timeout: float = 120.0) -> bool:
        """Wait until every submitted request finished both phases."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._prefills and not self._jobs, timeout)

    def shutdown(self) -> None:
        self._shutdown = True
        with self._cv:
            self._cv.notify_all()
        self._thread.join(5.0)
        if self.kv.tiered:
            # settle promotions whose prefill never started (abandoned
            # requests): abort reservations so the pool stays leak-free
            with self._cv:
                pending = [ps for ps in self._prefills.values()
                           if ps.ticket is not None]
            for ps in pending:
                ticket, ps.ticket = ps.ticket, None
                with self._kv_lock:
                    self.kv.promote_settle(ticket)
            self.kv.close()

    # ----------------------------------------------------------- supervision
    def _supervised(self) -> None:
        """Worker wrapper: catch any exception, strand the in-flight work to
        the Proxy and keep the THREAD alive so restart() is a state flip.
        The whole loop runs on the instance's stream."""
        with on_stream(self.stream):
            while True:
                try:
                    self._run()
                    return                  # clean shutdown
                except _Stranded:
                    continue                # its requests are handled
                except Exception as exc:
                    self._on_worker_failure(exc)

    def _check_inject(self) -> None:
        """Chaos hook at the round boundary: ("hang", s) stalls the worker
        outside every lock (so the watchdog can strand it); an Exception
        crashes the round."""
        inj = self._inject
        if inj is None:
            return
        self._inject = None
        if isinstance(inj, tuple) and inj and inj[0] == "hang":
            time.sleep(float(inj[1]))
            return
        if isinstance(inj, BaseException):
            raise inj
        raise RuntimeError(f"injected fault: {inj!r}")

    def inject_fault(self, fault: object) -> None:
        """Deliver a chaos-harness fault to the worker (core/faults.py)."""
        with self._cv:
            self._inject = fault
            self._cv.notify_all()

    def _on_worker_failure(self, exc: BaseException) -> None:
        """Strand EVERY in-flight request (both phases) to on_fault. The
        pool KV for this instance is considered lost: the Proxy re-dispatches
        from scratch (recompute > resurrecting half-written pool blocks).

        Beyond the reference, as `PrefillInstance._settle_abandoned`: the
        stranded requests' promotions are settled and their blocks freed,
        so a re-dispatch here can allocate again and a drain leaves no
        block behind."""
        with self._cv:
            if not self.healthy:
                return
            self.healthy = False
            self.last_error = exc
            prefills = list(self._prefills.values())
            stranded = [ps.request for ps in prefills]
            stranded += [j.request for j in self._jobs.values()]
            self._prefills.clear()
            self._jobs.clear()
            self._resident.clear()
            with self._kv_lock:
                self._epoch += 1
                for ps in prefills:
                    ticket, ps.ticket = ps.ticket, None
                    if ticket is not None:
                        self.kv.promote_settle(ticket)
                for r in stranded:
                    if self.kv.table(r.rid) is not None:
                        self.kv.free(r.rid)
            self._cv.notify_all()
        cb = self.on_fault
        if cb is not None:
            cb(stranded, exc)

    def restart(self) -> None:
        """Revive after a failure: the worker thread survived the exception
        (supervised), so this is just the health flip + progress stamp."""
        with self._cv:
            self.healthy = True
            self.last_error = None
            self._inject = None
            self.last_progress = self.clock()
            self._cv.notify_all()

    @property
    def progress_ts(self) -> float:
        """Watchdog signal: wall-clock of the last observed forward step."""
        return self.last_progress

    def _check_epoch(self) -> None:
        """Under _kv_lock: raise `_Stranded` if a strand freed this round's
        blocks (a worker that ran on through a strand, as after a hang)."""
        if self._epoch != self._round_epoch:
            raise _Stranded()

    # --------------------------------------------------------- KV lifecycle
    def _allocate(self, rid: int, need: int, keys):
        """Under _kv_lock: allocate, growing the pool rather than declining."""
        try:
            return self.kv.allocate(rid, need, keys=keys)
        except MemoryError:
            self.kv.grow_for(self.kv.blocks_needed(need))
            return self.kv.allocate(rid, need, keys=keys)

    def _need(self, ps: _Prefill) -> int:
        """Tokens reserved for a request: prompt, local decode, one more."""
        local = self.on_decode_ready is None
        return len(ps.tokens) + (max(ps.request.output_tokens, 0)
                                 if local else 0) + 1

    def _acquire(self, ps: _Prefill) -> None:
        """Arrival-time allocation: pin the cached prefix (share mode) and
        reserve prompt + decode-growth blocks. Grows the pool rather than
        declining — admission control is the dispatcher's job."""
        req = ps.request
        n = len(ps.tokens)
        keys = block_keys(ps.tokens, self.kv_block_size) \
            if self.prefix_share else None
        with self._kv_lock:
            table = self._allocate(req.rid, self._need(ps), keys)
            ps.hit = min(table.length, max(n - 1, 0))
            if self.kv.tiered:
                ps.ticket = self._begin_promotion(keys, n, table.length)
        ps.keys = tuple(keys) if keys else ()
        ps.allocated = True
        req.prefix_hit = ps.hit
        if ps.hit:
            self.prefix_hits += 1
            self.prefix_hit_tokens += ps.hit

    def _begin_promotion(self, keys, n: int, warm: int):
        """Under _kv_lock at arrival: start promoting the prompt's cold-tier
        chain extension when the predicted copy beats the recompute it saves
        (PrefillInstance._begin_promotion's gate against this instance's
        own TTFT predictor). Returns a PromotionTicket or None."""
        _, host_t, disk_t = self.kv.probe_tiers(keys)
        cap = max(n - 1, 0) - warm
        cold = min(host_t + disk_t, cap)
        if cold <= 0:
            return None
        pred = self.predictor
        if pred is not None:
            saved = max(float(pred.predict(n - warm))
                        - float(pred.predict(n - warm - cold)), 0.0)
            host_use = min(host_t, cold)
            if self.kv.promote_seconds(host_use, cold - host_use) >= saved:
                return None
        bs = self.kv_block_size
        ticket = self.kv.promote_async(keys,
                                       max_blocks=(cold + bs - 1) // bs)
        return ticket if ticket.blocks else None

    def _settle_promotion(self, ps: _Prefill) -> None:
        """First-slice settle: wait for the arrival-time promotion copies
        OUTSIDE the kv lock (the prefill BLOCKS on a copy still in flight —
        never crashes into one), then commit under it and re-pin the longer
        prefix. Failures degrade to the arrival hit: timeouts abort back to
        their tier, corrupt copies are dropped and recomputed."""
        ticket, ps.ticket = ps.ticket, None
        ticket.wait(self.promote_wait_s)
        req = ps.request
        n = len(ps.tokens)
        with self._kv_lock:
            committed = self.kv.promote_settle(ticket)
            self._check_epoch()
            if committed <= 0:
                return
            old_hit = ps.hit
            self.kv.free(req.rid)
            table = self._allocate(req.rid, self._need(ps), ps.keys)
            ps.hit = min(table.length, max(n - 1, 0))
        req.prefix_hit = ps.hit
        gained = max(ps.hit - old_hit, 0)
        self.prefix_promotions += committed
        self.prefix_promoted_tokens += gained
        if old_hit == 0 and ps.hit > 0:
            self.prefix_hits += 1
        self.prefix_hit_tokens += gained

    def _start_task(self, ps: _Prefill) -> None:
        """First admitted slice: build the device-resident prefill task,
        seeded from the pinned pool prefix on a hit (suffix-only compute)."""
        if ps.ticket is not None:
            self._settle_promotion(ps)
        req = ps.request
        arr = ps.tokens[None, :]
        lens = [len(ps.tokens)]
        P = ps.hit
        if P > 0:
            with self._kv_lock:
                self._check_epoch()
                k, v, _ = self.kv.gather(req.rid)
            ps.task = self.executor.start(
                arr, lens=lens, prefix_len=P,
                prefix_k=k[:, None, :P], prefix_v=v[:, None, :P])
        else:
            ps.task = self.executor.start(arr, lens=lens)
        ps.done_tokens = P
        ps.started = self.clock()
        req.state = RequestState.RUNNING
        req.ops_total = ps.task.total_segments
        req.ops_done = 0

    def _publish(self, ps: _Prefill, now: float) -> int:
        """Prefill completion: scatter the computed suffix KV into the
        request's own pool blocks (the phase transition — the decode batch
        gathers from these same blocks next step) and register the prompt in
        the prefix trie. Returns the first decoded token."""
        req = ps.request
        st = ps.task.state
        n = int(st["lens"][0])
        with self._kv_lock:
            self._check_epoch()
            table = self.kv.table(req.rid)
            start = table.prefix_blocks * self.kv_block_size
            if start < n:
                self.kv.write_prompt(req.rid, st["k_cache"][:, 0, start:n],
                                     st["v_cache"][:, 0, start:n],
                                     start=start)
            if ps.keys:
                self.kv.insert(req.rid, ps.keys)
        req.first_token_time = now
        req.state = RequestState.DONE
        req.ops_done = req.ops_total
        observe = getattr(self.predictor, "observe", None)
        if observe is not None and ps.started > 0:
            # refit pair: suffix actually computed -> elapsed compute time
            observe(n - ps.hit, now - ps.started)
        return int(ps.task.logits[0].argmax())

    def _offload(self, req: Request, first_token: int, now: float) -> None:
        """Mixed-pool handoff: extract the dense cache a DecodeInstance
        ingests and release the pool blocks (prompt blocks stay trie-cached
        in share mode).

        The reference waits for its gathered arrays before freeing. Here the
        gather is a fresh buffer made on the pool's stream, so every later
        write to the freed blocks is queued behind it; the job carries that
        buffer (padded into a new one) with the event after it ("ready"),
        which the receiving instance waits on (`DecodeInstance._adopt`)."""
        target = req.output_tokens if req.output_tokens > 0 \
            else self.decode_tokens
        with self._kv_lock:
            self._check_epoch()
            k, v, length = self.kv.gather(req.rid)
            self.kv.free(req.rid)
        n = req.num_tokens
        need = n + target + 1
        keep = max(n, int(length))
        k, v = k[:, None, :keep], v[:, None, :keep]
        if keep < need:
            pad = (0, 0, 0, 0, 0, need - keep)     # (L, 1, T, K, hd): T only
            k, v = F.pad(k, pad), F.pad(v, pad)
        job = DecodeJob(request=req,
                        cache={"k": k, "v": v, "pos": n,
                               "ready": mark(self.device)},
                        first_token=first_token)
        self.on_decode_ready(job)

    def _join_local(self, req: Request, first_token: int, now: float) -> None:
        """No-handoff decode join: the KV is already in the shared pool."""
        target = req.output_tokens if req.output_tokens > 0 \
            else self.decode_tokens
        req.decode_start = now
        if req.output_tokens <= 0:
            req.output_tokens = target
        job = HybridJob(request=req, first_token=first_token, enqueued=now,
                        target=target, base_len=req.num_tokens,
                        last_emit=now, emitted=[first_token])
        with self._cv:
            job.order = self._order
            self._order += 1
            self._jobs[req.rid] = job

    # --------------------------------------------------------------- decode
    def _bucket(self, n: int) -> int:
        for b in self._b_buckets:
            if b >= n:
                return b
        return self._b_buckets[-1]

    def _t_step(self, b: int, ctx: float) -> float:
        if self.step_pred is not None:
            return self.step_pred.step_time(b, ctx)
        return self._tbt_ema

    def _observe(self, b: int, ctx: float, dt: float) -> None:
        a = 0.1 if self._tbt_ema > 0 else 1.0
        self._tbt_ema += a * (dt - self._tbt_ema)
        if self.step_pred is not None:
            self.step_pred.observe(b, ctx, dt)

    def _entry(self, job: HybridJob) -> DecodeEntry:
        return DecodeEntry(key=job.request.rid,
                           remaining_tokens=float(job.target
                                                  - job.tokens_done),
                           deadline=job.request.decode_deadline,
                           order=job.order)

    def _cadence(self, jobs: List[HybridJob]) -> float:
        """Seconds between woven decode steps: ``cadence_margin x`` the
        tightest resident TBT SLO (the margin absorbs the segment we are
        mid-way through when the cadence fires)."""
        if self.decode_cadence > 0:
            return self.decode_cadence
        slos = [j.request.tbt_slo for j in jobs
                if j.request.tbt_slo and j.request.tbt_slo > 0]
        if not slos:
            return 0.05
        return self.cadence_margin * min(slos)

    def _decode_step(self, jobs: List[HybridJob]) -> List[HybridJob]:
        """One decode step over the resident batch against the SHARED pool
        (DecodeInstance's `_step_batch` shape). Returns the still-unfinished
        jobs."""
        jobs = [j for j in jobs if j.tokens_done < j.target]
        if not jobs:
            return jobs
        n = len(jobs)
        bb = self._bucket(n)
        seq_ids = [j.request.rid for j in jobs] + [_SCRATCH_SEQ] * (bb - n)
        kv_lens = np.zeros(bb, np.int64)
        tokens = np.zeros(bb, np.int64)
        for i, j in enumerate(jobs):
            kv_lens[i] = j.base_len + j.tokens_done
            tokens[i] = j.first_token if j.next_token is None else j.next_token
        t0 = self.clock()
        with self._kv_lock:
            self._check_epoch()
            # pow2 width over ALLOCATED blocks (not kv_len): per-stream
            # allocation sizes must not leak into the stepped shape
            need_blocks = max(
                (len(self.kv.table(j.request.rid).blocks) for j in jobs),
                default=1)
            width = 1
            while width < need_blocks:
                width *= 2
            self._shapes.add((bb, width, 1))
            k_g, v_g, _ = self.kv.gather_batch(seq_ids, width)
            logits, k_new, v_new = decode_step_ragged(
                self.params, self.cfg,
                torch.as_tensor(tokens, device=self.device), k_g, v_g,
                torch.as_tensor(kv_lens, device=self.device))
            next_tokens = logits.argmax(-1).tolist()
            self.kv.write_tokens(seq_ids, kv_lens.tolist(), k_new, v_new)
            if self.stream is not None:
                # as DecodeInstance._step_batch: stamp the token after the
                # scatter has run on the card, not when it was queued
                self.stream.synchronize()
        now = self.clock()
        self.steps += 1
        self._last_decode = now
        self.last_progress = now
        self._observe(n, float(kv_lens[:n].mean()), now - t0)
        alive: List[HybridJob] = []
        done: List[HybridJob] = []
        for i, j in enumerate(jobs):
            # TRUE inter-token gap (includes any weave pause) — the honest
            # TBT the fig24 attainment row gates on
            self.tbt_samples.append(now - j.last_emit)
            j.last_emit = now
            j.tokens_done += 1
            j.next_token = int(next_tokens[i])
            j.emitted.append(int(next_tokens[i]))
            (done if j.tokens_done >= j.target else alive).append(j)
        if done:
            with self._cv:
                for j in done:
                    rid = j.request.rid
                    if self._jobs.get(rid) is not j:
                        # stranded mid-round (watchdog): the request was
                        # re-dispatched — completing it twice is the one
                        # thing the recovery invariant forbids
                        continue
                    j.request.finish_time = now
                    j.request.mean_tpot = (now - j.enqueued) \
                        / max(j.target, 1)
                    self.finished.append(j.request)
                    self.finished_jobs.append(j)
                    self._jobs.pop(rid, None)
                    self._resident.discard(rid)
                    with self._kv_lock:
                        # refcount decrement: trie-registered prompt blocks
                        # stay cached for the next matching prompt
                        self.kv.free(rid)
                self._cv.notify_all()
        return alive

    def _maybe_weave(self, jobs: List[HybridJob]) -> List[HybridJob]:
        """Between-segment cadence check: the operator boundary IS the
        preemption point — if the resident batch is due a token, run one
        decode step before the next segment."""
        if jobs and self.clock() - self._last_decode >= self._cadence(jobs):
            return self._decode_step(jobs)
        return jobs

    # ---------------------------------------------------------------- worker
    def _has_work_locked(self) -> bool:
        return bool(self._prefills) or bool(self._jobs)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not (self._has_work_locked() and self.healthy) \
                        and not self._shutdown and self._inject is None:
                    self._cv.wait(0.1)
                if self._shutdown and not self._has_work_locked():
                    return
                if not self.healthy and self._inject is None:
                    continue                # zombie guard until restart()
                now = self.clock()
                prefills = [ps.request for ps in self._prefills.values()]
                done_map = {rid: ps.done_tokens
                            for rid, ps in self._prefills.items()}
                entries = [self._entry(j) for j in self._jobs.values()]
                resident = set(self._resident)
                ctx = (sum(j.base_len + j.tokens_done
                           for j in self._jobs.values()) / len(self._jobs)
                       if self._jobs else 0.0)
                self._round_epoch = self._epoch
            self._check_inject()
            self.last_progress = self.clock()
            b = min(len(entries), self.decode_max_batch)
            plan = self.core.plan_step(
                now, prefill=prefills, prefill_done=done_map,
                decode_entries=entries, decode_resident=resident,
                t_step=self._t_step(max(b, 1), ctx))
            if plan.empty:
                continue
            self.rounds += 1
            with self._cv:
                for rid in plan.preempted_decode:
                    job = self._jobs.get(rid)
                    if job is not None:
                        job.request.decode_preemptions += 1
                        self.preemptions += 1
                self._resident = set(plan.decode_keys)
                jobs = [self._jobs[rid] for rid in plan.decode_keys
                        if rid in self._jobs]
            self._round(plan, jobs)

    def _round(self, plan, jobs: List[HybridJob]) -> None:
        """Execute one planned hybrid step: each prefill slice advances one
        chunk of operator segments with decode steps woven between them; a
        decode-only plan is a single batched step (a dedicated decode
        instance's cadence, exactly)."""
        decoded0 = self.steps
        # Unlike the reference, the host may queue at most _WEAVE_DEPTH
        # segments ahead of the device (ExecutionPool._run_task's window):
        # `step` only enqueues, so without the bound the cadence check would
        # fire by the host's clock and the woven step would queue behind a
        # whole chunk. On the CPU every token is None and `wait` a no-op.
        window: List = []
        for sl in plan.prefill_slices:
            with self._cv:
                ps = self._prefills.get(sl.key)
            if ps is None:
                continue
            if ps.task is None:
                self._start_task(ps)
            task = ps.task
            spc = self.executor._segments_per_chunk
            target = task.cursor + spc
            if target >= task.total_segments - 1:
                target = task.total_segments            # run the head too
            while task.cursor < target and not task.done:
                self.executor.step(task)
                window.append(task.sync_token)
                if len(window) > _WEAVE_DEPTH:
                    wait(window.pop(0))
                self.last_progress = self.clock()
                if not task.done:
                    jobs = self._maybe_weave(jobs)
            chunks_done = task.cursor // spc
            ps.done_tokens = min(
                task.start_offset + chunks_done * task.chunk,
                ps.request.num_tokens)
            ps.request.ops_done = task.cursor
            if task.done:
                req = ps.request
                with self._cv:
                    if self._prefills.get(req.rid) is not ps:
                        # stranded mid-chunk: the request was re-dispatched
                        # — publishing this incarnation's result would race
                        # (or double) the recovery's
                        continue
                # as ExecutionPool's completion: stamp the first token once
                # the head has run on the card, not when it was queued
                wait(task.sync_token)
                now = self.clock()
                first = self._publish(ps, now)
                with self._cv:
                    self._prefills.pop(req.rid, None)
                self.prefilled.append(req)
                if self.on_decode_ready is not None:
                    self._offload(req, first, now)
                elif req.output_tokens > 0:
                    self._join_local(req, first, now)
                    with self._cv:
                        job = self._jobs.get(req.rid)
                    # a fresh stream is owed its first token promptly: it
                    # joins the in-flight batch mid-round
                    if job is not None:
                        jobs = jobs + [job]
                        with self._cv:
                            self._resident.add(req.rid)
                else:
                    with self._kv_lock:
                        self._check_epoch()
                        self.kv.free(req.rid)       # prefill-only request
                with self._cv:
                    self._cv.notify_all()
        if jobs and self.steps == decoded0:
            # the plan admitted these streams for this step — a round must
            # never complete without their token (the one-budget-token
            # promise the fairness property tests assert)
            self._decode_step(jobs)
