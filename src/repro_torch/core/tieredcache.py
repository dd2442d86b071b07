"""Tiered prefix-cache residency: HBM -> host -> disk block offload.

`PrefixBlockManager` (repro_torch.core.prefixcache) drops a refcount-0 block's
content at LRU capacity — every eviction is a future recompute. At
millions-of-users scale the shared-prefix working set dwarfs device memory,
so `TieredBlockManager` DEMOTES instead: an evicted block's chain key moves
to a host-memory tier (and, overflowing that, to an optional disk tier);
the HBM block itself is still reused immediately. A later probe that walks
past the warm (HBM-resident) run into a cold tier reports tier-tagged hit
lengths, and the owner decides whether to PROMOTE — reserve fresh HBM
blocks, copy the KV back, re-register the keys — priced against the
recompute the hit would otherwise save (the same transfer-vs-recompute
shape as cost-gated decode migration).

Like the parent class this is the POLICY half, shared by two owners
("evaluated is deployed"):

  * `repro_torch.serving.kvcache.PagedKVCache` (``host_cache_blocks > 0``) pairs
    it with real jnp pools: demotion snapshots the block's K/V through the
    async `BlockCopyEngine` into checksummed host numpy storage (spilling
    to ``.npz`` files on disk), promotion verifies the checksum and
    scatters the data back — a corrupt or lost copy falls back to
    recompute, never serves stale KV;
  * `repro_torch.sim.cluster.ClusterSim` (``host_cache_blocks > 0``) uses it bare
    as the tier-aware residency model: state moves are instantaneous and
    the promotion latency is priced by `PrefillCostModel.promote_time`
    (a delayed-arrival event).

Tier lifecycle (state machine; docs/ARCHITECTURE.md has the diagram):

    FREE / LIVE / CACHED                       (HBM — parent lifecycle)
    CACHED --LRU evict--> HOST                 (key demoted; block reused)
    HOST --host LRU overflow--> DISK           (disk_blocks > 0, else drop)
    DISK --disk LRU overflow--> dropped
    HOST|DISK --promote_begin--> IN_FLIGHT     (an HBM block is reserved)
    IN_FLIGHT --promote_commit--> CACHED       (copy landed, re-registered)
    IN_FLIGHT --promote_abort--> FREE          (+ key restored to its tier,
                                                or dropped when corrupt)

Tier-adjusted conservation (`check` — asserted by the hypothesis/fallback
property suites in tests/test_property.py and tests/test_tiered_kv.py):

    free + live + cached + in_flight == num_blocks      (HBM, disjoint)
    a chain key resides in AT MOST one place: trie (warm), in-flight,
    host, or disk; len(host) <= host_blocks, len(disk) <= disk_blocks.
    (One legal transient: a twin prompt registering a key whose promotion
    is still in flight — `promote_commit` resolves it by freeing the
    reserved block.)

Pinned (refcount > 0) blocks are never demoted: demotion's only source is
the LRU of refcount-0 CACHED blocks, exactly like the parent's eviction.
"""
from __future__ import annotations

import queue
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# tier tags (also the order of degradation: lower = hotter)
TIER_HBM, TIER_HOST, TIER_DISK = 0, 1, 2
TIER_NAMES = {TIER_HBM: "hbm", TIER_HOST: "host", TIER_DISK: "disk"}

from repro_torch.core.prefixcache import PrefixBlockManager

__all__ = ["TIER_HBM", "TIER_HOST", "TIER_DISK", "TIER_NAMES", "TierHit",
           "TieredBlockManager", "BlockCopyEngine", "CopyJob",
           "TierDataError", "block_checksum"]


class TierDataError(Exception):
    """A stored tier copy is corrupt or lost (checksum mismatch, missing
    host entry, unreadable disk file). The promotion must abort-with-drop
    and the prefill falls back to recompute — stale KV is never served."""


def block_checksum(*arrays) -> int:
    """crc32 over the raw bytes of the block's K/V arrays — cheap integrity
    tag computed at demotion and verified at promotion (a host copy that
    rotted or was lost must fall back to recompute, never into the pool)."""
    crc = 0
    for a in arrays:
        crc = zlib.crc32(memoryview(a).cast("B"), crc)
    return crc & 0xFFFFFFFF


@dataclass(frozen=True)
class TierHit:
    """Tier-tagged probe result, in BLOCKS: the warm (HBM trie) run, then
    the contiguous cold run split by tier. ``host_blocks`` includes keys
    whose promotion is already in flight (they will be warm by the time a
    dependent prefill resumes)."""
    hbm_blocks: int = 0
    host_blocks: int = 0
    disk_blocks: int = 0

    @property
    def cold_blocks(self) -> int:
        return self.host_blocks + self.disk_blocks

    @property
    def total_blocks(self) -> int:
        return self.hbm_blocks + self.cold_blocks


class TieredBlockManager(PrefixBlockManager):
    """`PrefixBlockManager` whose LRU eviction demotes through host/disk
    tiers instead of dropping content, plus an explicit three-step
    promotion protocol (begin -> commit | abort) so an async copy engine
    can move the data while the reserved HBM block sits IN_FLIGHT.

    ``host_blocks == 0`` disables tiering entirely — every code path then
    reduces exactly to the parent (pinned by tests/test_tiered_kv.py), so
    the single-tier default stays bit-identical.

    Owner hooks (both optional; the sim uses neither):
      * ``on_demote(key, block, tier)`` — fires BEFORE the demoted HBM
        block is handed out for reuse (tier == TIER_HOST, block is the id
        whose data must be snapshotted now) and when a host entry spills
        to disk (tier == TIER_DISK, block is None — the owner moves its
        host copy);
      * ``on_drop(key, tier)`` — a cold-tier entry aged out; the owner
        frees its stored data.
    """

    def __init__(self, num_blocks: int, *, host_blocks: int = 0,
                 disk_blocks: int = 0,
                 on_demote: Optional[Callable[[int, Optional[int], int],
                                              None]] = None,
                 on_drop: Optional[Callable[[int, int], None]] = None):
        super().__init__(num_blocks)
        self.host_capacity = host_blocks
        self.disk_capacity = disk_blocks
        self.on_demote = on_demote
        self.on_drop = on_drop
        self._host: "OrderedDict[int, None]" = OrderedDict()  # key LRU
        self._disk: "OrderedDict[int, None]" = OrderedDict()  # key LRU
        self._promoting: Dict[int, int] = {}       # key -> reserved block
        self._promote_src: Dict[int, int] = {}     # key -> source tier
        self.demotions = 0                         # HBM -> host moves
        self.spills = 0                            # host -> disk moves
        self.tier_drops = 0                        # cold entries aged out
        self.promotions = 0                        # commits (blocks re-warmed)
        self.promote_aborts = 0

    # ------------------------------------------------------------- inventory
    @property
    def host_entries(self) -> int:
        return len(self._host)

    @property
    def disk_entries(self) -> int:
        return len(self._disk)

    @property
    def in_flight(self) -> int:
        """HBM blocks reserved for promotions still being copied."""
        return len(self._promoting)

    def check(self) -> None:
        """Tier-adjusted conservation (module docstring). Extends the parent
        invariant with the IN_FLIGHT state and key-exclusivity across
        tiers; cheap enough to call after every op in the property suites."""
        live = set(self._ref)
        free = set(self._free)
        cached = set(self._lru)
        inflight = set(self._promoting.values())
        assert len(free) == len(self._free), "free list duplicate"
        assert len(inflight) == len(self._promoting), \
            "one block reserved for two promotions"
        sets = (live, free, cached, inflight)
        for i, a in enumerate(sets):
            for b in sets[i + 1:]:
                assert not (a & b), "block in two states"
        assert len(free) + len(live) + len(cached) + len(inflight) \
            == self.num_blocks, (
                f"leak: {len(free)} free + {len(live)} live + "
                f"{len(cached)} cached + {len(inflight)} in_flight "
                f"!= {self.num_blocks}")
        for keys_b, b in self._trie.items():
            assert self._key_of.get(b) == keys_b, "trie/key_of out of sync"
        held_all = [b for bs in self._held.values() for b in bs]
        from collections import Counter
        assert dict(Counter(held_all)) == self._ref, \
            "refcounts != held references"
        # key exclusivity: warm, in-flight, host, disk are disjoint key sets
        # — with ONE legal transient: a twin prompt may register a key whose
        # promotion is still in flight (warm & in-flight overlap); the race
        # resolves at `promote_commit`, which frees the reserved block
        warm = set(self._trie)
        fly = set(self._promoting)
        host = set(self._host)
        disk = set(self._disk)
        for a, b in ((warm, host), (warm, disk), (fly, host), (fly, disk),
                     (host, disk)):
            assert not (a & b), "chain key in two tiers"
        assert fly == set(self._promote_src), "in-flight source tier lost"
        if self.host_capacity >= 0:
            assert len(host) <= self.host_capacity, "host tier over capacity"
        assert len(disk) <= self.disk_capacity, "disk tier over capacity"

    # ------------------------------------------------------------- demotion
    def _take_block(self) -> Optional[int]:
        """Parent semantics (free list, then LRU eviction) — but the evicted
        key's content is demoted to the host tier instead of vanishing.
        Pinned blocks are untouchable here by construction: only CACHED
        (refcount-0) blocks live in the LRU."""
        if self._free:
            return self._free.pop()
        if self._lru:
            b, _ = self._lru.popitem(last=False)
            key = self._key_of.pop(b)
            del self._trie[key]
            self.evictions += 1
            if self.host_capacity > 0:
                self._demote(key, b)
            return b
        return None

    def _demote(self, key: int, block: int) -> None:
        """key's content leaves HBM: enter the host tier (MRU), cascading
        host overflow into the disk tier and disk overflow into a drop.
        The owner's ``on_demote`` snapshot hook fires BEFORE this returns —
        i.e. before the freed HBM block can be reused."""
        self._disk.pop(key, None)          # exclusivity: host copy is fresher
        if self.on_demote is not None:
            self.on_demote(key, block, TIER_HOST)
        self._host[key] = None
        self._host.move_to_end(key)
        self.demotions += 1
        self._enforce_cold_capacity()

    def _enforce_cold_capacity(self) -> None:
        """Age out cold-tier overflow: host LRU spills into disk (when one
        exists, else drops), disk LRU drops. Called after every insertion
        into a cold tier — demotion AND a `promote_abort` restore (the tier
        may have filled up while the aborted copy was in flight)."""
        while len(self._host) > self.host_capacity:
            k2, _ = self._host.popitem(last=False)
            if self.disk_capacity > 0:
                if self.on_demote is not None:
                    self.on_demote(k2, None, TIER_DISK)
                self._disk[k2] = None
                self._disk.move_to_end(k2)
                self.spills += 1
            else:
                self.tier_drops += 1
                if self.on_drop is not None:
                    self.on_drop(k2, TIER_HOST)
        while len(self._disk) > self.disk_capacity:
            k3, _ = self._disk.popitem(last=False)
            self.tier_drops += 1
            if self.on_drop is not None:
                self.on_drop(k3, TIER_DISK)

    def _drop_cold(self, key: int) -> None:
        """A freshly computed copy of `key` is being registered: any cold
        copy is now redundant AND must leave its tier (key exclusivity) —
        the owner frees its stored data via ``on_drop``. An in-flight
        promotion of the key is left alone: `promote_commit` detects the
        twin registration and frees its reserved block."""
        for tier, store in ((TIER_HOST, self._host), (TIER_DISK, self._disk)):
            if key in store:
                del store[key]
                self.tier_drops += 1
                if self.on_drop is not None:
                    self.on_drop(key, tier)

    def register(self, seq_id: int, keys: Sequence[int]) -> int:
        """Parent `register`, plus tier exclusivity: each key actually
        registered supersedes (drops) its cold copy — the recompute path
        produced fresher content than the demoted snapshot."""
        blocks = self._held[seq_id]
        added = 0
        for k, b in zip(keys, blocks):
            if k in self._trie or b in self._key_of:
                continue
            self._drop_cold(k)
            self._trie[k] = b
            self._key_of[b] = k
            added += 1
        return added

    def commit(self, seq_id: int, keys: Sequence[int]) -> int:
        """Parent `commit` (simulator completion path), with the same
        supersede-cold-copy step per key newly registered."""
        held = self._held[seq_id]
        hit = len(held)
        added = 0
        for k in keys[hit:]:
            if k in self._trie:
                continue
            b = self._take_block()
            if b is None:
                break
            self._drop_cold(k)
            self._ref[b] = 1
            held.append(b)
            self._trie[k] = b
            self._key_of[b] = k
            added += 1
        self.release(seq_id)
        return added

    # -------------------------------------------------------------- probing
    def probe_tiers(self, keys: Sequence[int]) -> TierHit:
        """Tier-tagged hit lengths: the warm run (exactly `probe` — touches
        the HBM LRU), then the contiguous cold run classified per tier.
        A key whose promotion is in flight counts as a host hit (it is on
        its way up). Stops at the first key absent everywhere."""
        warm = len(self.probe(keys))
        host = disk = 0
        for k in keys[warm:]:
            if k in self._host or k in self._promoting:
                host += 1
                if k in self._host:
                    self._host.move_to_end(k)      # a probe is a touch
            elif k in self._disk:
                disk += 1
                self._disk.move_to_end(k)
            else:
                break
        return TierHit(hbm_blocks=warm, host_blocks=host, disk_blocks=disk)

    # ------------------------------------------------------------ promotion
    def promote_begin(self, keys: Sequence[int],
                      max_blocks: Optional[int] = None) \
            -> List[Tuple[int, int, int]]:
        """Reserve HBM blocks for the cold extension of `keys`' warm run.
        Each reservable cold key is popped from its tier and parked
        IN_FLIGHT on a freshly taken block (which may itself demote other
        cached keys — the key being promoted is popped FIRST so the cascade
        cannot age it out from under us). Keys already warm or already in
        flight are skipped (in-flight dedup); the walk stops at the first
        key absent everywhere or when the pool has nothing to give.

        Returns ``[(key, reserved_block, source_tier)]`` — the copy
        manifest. Every entry MUST eventually reach `promote_commit` or
        `promote_abort` (the property suites assert no in-flight leaks)."""
        out: List[Tuple[int, int, int]] = []
        budget = len(keys) if max_blocks is None else max_blocks
        for k in keys:
            if k in self._trie or k in self._promoting:
                continue                    # warm, or someone is on it
            if len(out) >= budget:
                break
            if k in self._host:
                tier = TIER_HOST
                del self._host[k]
            elif k in self._disk:
                tier = TIER_DISK
                del self._disk[k]
            else:
                break                       # cold run ends here
            b = self._take_block()
            if b is None:                   # pool exhausted: restore, stop
                tgt = self._host if tier == TIER_HOST else self._disk
                tgt[k] = None
                break
            self._promoting[k] = b
            self._promote_src[k] = tier
            out.append((k, b, tier))
        return out

    def promote_commit(self, key: int) -> Optional[int]:
        """The copy landed: the reserved block becomes CACHED (refcount 0,
        MRU) and the key re-registers in the trie. Returns the block — or
        None when a twin prompt registered the key meanwhile (the reserved
        block is freed; the twin's copy is the live one)."""
        b = self._promoting.pop(key)
        del self._promote_src[key]
        if key in self._trie:
            self._free.append(b)
            return None
        self._trie[key] = b
        self._key_of[b] = key
        self._lru[b] = None
        self.promotions += 1
        return b

    def promote_abort(self, key: int, corrupt: bool = False) -> None:
        """The copy failed or was cancelled: free the reserved block. The
        key returns to its source tier (MRU — it is still the best copy we
        have) unless ``corrupt``, in which case it is dropped outright:
        a checksum-mismatched copy must never be probed into again."""
        b = self._promoting.pop(key)
        tier = self._promote_src.pop(key)
        self._free.append(b)
        self.promote_aborts += 1
        if corrupt:
            self.tier_drops += 1
            if self.on_drop is not None:
                self.on_drop(key, tier)
            return
        if key in self._trie:
            return                          # twin raced us in: nothing to keep
        tgt = self._host if tier == TIER_HOST else self._disk
        tgt[key] = None
        tgt.move_to_end(key)
        self._enforce_cold_capacity()       # the tier may have filled since


# ---------------------------------------------------------------------------
# Async block-copy engine
# ---------------------------------------------------------------------------


class CopyJob:
    """One tier transfer. ``wait`` blocks until the worker ran it (or the
    engine shut down); ``result`` / ``error`` carry the outcome. Jobs are
    deduplicated per (kind, key) while in flight, so callers may hold the
    same job object."""

    __slots__ = ("kind", "key", "fn", "done", "result", "error")

    def __init__(self, kind: str, key: int, fn: Callable[[], object]):
        self.kind = kind
        self.key = key
        self.fn = fn
        self.done = threading.Event()
        self.result: object = None
        self.error: Optional[BaseException] = None

    @property
    def ok(self) -> bool:
        return self.done.is_set() and self.error is None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class _Shutdown(Exception):
    """Marks jobs cancelled by engine shutdown (drained, not run)."""


class BlockCopyEngine:
    """Bounded background worker for tier transfers (demotions, disk
    spills, promotions) with per-(kind, key) in-flight dedup.

    ONE worker thread by default: per-key ordering then falls out of FIFO
    submission (a key's host snapshot lands before its disk spill or its
    promotion reads it), which is exactly the dependency chain the tiered
    `PagedKVCache` relies on. The queue is bounded — a submitter that
    outruns the copy bandwidth blocks briefly instead of buffering
    unboundedly (backpressure, not OOM).

    `shutdown` drains cleanly: queued-but-unrun jobs complete with a
    `_Shutdown` error so every waiter wakes and every reserved block can be
    aborted back to the pool — no leaked blocks, no hung prefill
    (tests/test_tiered_kv.py fault-injection suite).

    Fault-injection hooks (tests only): ``fail_keys`` makes the worker
    error any job touching those keys; ``delay_s`` sleeps before each job
    (to hold transfers in flight across a shutdown)."""

    def __init__(self, workers: int = 1, max_queue: int = 256):
        self._q: "queue.Queue[Optional[CopyJob]]" = queue.Queue(max_queue)
        self._lock = threading.Lock()
        self._inflight: Dict[Tuple[str, int], CopyJob] = {}
        self._closed = False
        self.completed = 0
        self.failed = 0
        self.fail_keys: set = set()
        self.delay_s: float = 0.0
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"block-copy-{i}")
            for i in range(max(workers, 1))]
        for t in self._threads:
            t.start()

    # ---------------------------------------------------------------- submit
    def submit(self, kind: str, key: int,
               fn: Callable[[], object]) -> CopyJob:
        """Enqueue a transfer; an identical in-flight (kind, key) job is
        returned instead of queuing a duplicate copy."""
        with self._lock:
            if self._closed:
                job = CopyJob(kind, key, fn)
                job.error = _Shutdown("engine closed")
                job.done.set()
                return job
            existing = self._inflight.get((kind, key))
            if existing is not None:
                return existing
            job = CopyJob(kind, key, fn)
            self._inflight[(kind, key)] = job
        self._q.put(job)
        return job

    def _finish(self, job: CopyJob) -> None:
        with self._lock:
            cur = self._inflight.get((job.kind, job.key))
            if cur is job:
                del self._inflight[(job.kind, job.key)]
        job.done.set()

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                if self.delay_s > 0:
                    # fault injection: keep the transfer "on the wire"
                    import time as _time
                    _time.sleep(self.delay_s)
                if self._closed:
                    raise _Shutdown("engine closed with transfer in flight")
                if job.key in self.fail_keys:
                    raise IOError(f"injected copy failure for key {job.key}")
                job.result = job.fn()
                self.completed += 1
            except BaseException as e:      # noqa: BLE001 — jobs never raise
                job.error = e
                self.failed += 1
            finally:
                self._finish(job)
                self._q.task_done()

    # ----------------------------------------------------------------- drain
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for every queued job to finish. True when the queue emptied
        within `timeout` (None = wait forever)."""
        if timeout is None:
            self._q.join()
            return True
        import time as _time
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    return True
            _time.sleep(0.002)
        with self._lock:
            return not self._inflight

    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        """Stop accepting work and drain. Jobs still queued when the flag
        flips complete with a `_Shutdown` error (their waiters wake and
        abort their reservations) — a clean drain, never a hang."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for _ in self._threads:
            self._q.put(None)
        if wait:
            for t in self._threads:
                t.join(timeout)
