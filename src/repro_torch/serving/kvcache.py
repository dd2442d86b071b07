"""Paged KV cache manager (vLLM-style block tables) on torch tensors.

The decode instance allocates cache blocks per sequence from a shared pool;
`gather` materializes a contiguous (T, K, hd) view per layer, and the
continuous-batching decode runtime uses the batched pool I/O:

  * ``write_tokens(seq_ids, positions, k, v)`` — one in-place `index_put_`
    writes every resident stream's new token per step.
  * ``write_token_span(seq_ids, positions, counts, k, v)`` — the
    speculative-verify sibling: writes an S-token span per stream but
    commits only ``counts[i]`` of it (rollback by length).
  * ``gather_batch(seq_ids, width)`` — one `index_select` materializes the
    whole resident set as (L, B, T_pad, K, hd) dense views for the batched
    decode step, rows padded to a common block count.

PREFIX SHARING (``prefix_share=True``): block accounting is delegated to a
`repro_torch.core.prefixcache.PrefixBlockManager` — per-block refcounts, a
prefix trie keyed on token-id block hashes (`block_keys`), LRU retention of
refcount-0 blocks instead of eager free, and copy-on-write when a write
lands in a shared or cached block. ``allocate(seq, n, keys=...)`` pins the
cached prefix and allocates only the suffix; `free` becomes a refcount
decrement. The default (``prefix_share=False``) keeps the plain LIFO
allocator and eager free.

TIERS (``host_cache_blocks > 0``, share mode only): a
`repro_torch.core.tieredcache.TieredBlockManager` demotes LRU-evicted
cached blocks to checksummed host copies (spilling on to ``.npz`` files in
a temp dir the cache owns), moved by a `BlockCopyEngine` worker, and
`promote_async` / `promote_settle` bring them back. A lost or corrupt copy
aborts its promotion and the prompt recomputes those tokens.

On the card every pool read and write runs on one stream, ``stream`` (the
owning instance's; the current stream at construction by default). The
tiers' device work is ordered on it: a demoted block is cloned on it before
the block can be reused, and a promoted block is written into the pool on
it. The copy worker moves bytes on a stream of its own and meets the pool's
through events.

Counterpart of src/repro/serving/kvcache.py: the reference's donated jitted
scatters and gathers become in-place writes and index selects on the pool
tensors.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.prefixcache import PrefixBlockManager, block_keys
from repro_torch.core.tieredcache import (TIER_HOST, BlockCopyEngine,
                                          TierDataError, TieredBlockManager,
                                          block_checksum)
from repro_torch.models.segments import mark, on_stream

__all__ = ["BlockTable", "PagedKVCache", "PromotionTicket", "block_keys",
           "raw_bytes"]


def raw_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as uint8 (its last dim times the element size).
    numpy has no bf16, so the host tiers keep raw bytes beside the dtype's
    name, and crc32 over them is `block_checksum` over the same values."""
    return t.contiguous().view(torch.uint8)


class PromotionTicket:
    """Handle for one batch of in-flight tier promotions started by
    `PagedKVCache.promote_async`. The protocol that keeps this deadlock-free:
    `wait` OUTSIDE the owner's kv lock (copy workers never take it), then
    `PagedKVCache.promote_settle(ticket)` UNDER the lock. A prefill that
    depends on the promoted blocks therefore BLOCKS until the copies land
    (or time out and abort back to their tier) — it never crashes into a
    half-copied block."""

    __slots__ = ("items",)

    def __init__(self, items):
        self.items = items               # [(key, reserved_block, tier, job)]

    @property
    def blocks(self) -> int:
        return len(self.items)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """True once every copy job finished (ok or errored) in time."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for _, _, _, job in self.items:
            t = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            if not job.wait(t):
                return False
        return True


@dataclass
class BlockTable:
    seq_id: int
    blocks: List[int] = field(default_factory=list)
    length: int = 0                      # tokens currently stored
    prefix_blocks: int = 0               # leading blocks served from the
                                         # shared cache (prefix_share only)


class PagedKVCache:
    """Block pool shared by all sequences on one instance.

    Storage layout: k/v pools of shape (L, num_blocks, block_size, K, hd)
    on `device`; the v pool's last axis is `v_head_dim` where given (a
    latent-attention stack's pools hold c_kv and k_pe, one head each, of
    512 and 64 at published size). ``prefix_share=True`` turns on block-level prefix sharing
    and ``host_cache_blocks > 0`` the host/disk tiers (module docstring);
    ``max_blocks`` caps `extend`'s geometric pool growth (0 = unbounded).
    """

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, *, device="cuda",
                 prefix_share: bool = False, max_blocks: int = 0,
                 host_cache_blocks: int = 0, disk_cache_blocks: int = 0,
                 disk_cache_dir: Optional[str] = None,
                 copy_engine: Optional[BlockCopyEngine] = None,
                 host_bw: float = 25e9, host_latency: float = 5e-4,
                 disk_bw: float = 3e9, disk_latency: float = 5e-3,
                 stream: Optional[torch.cuda.Stream] = None,
                 v_head_dim: int = 0):
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks = max_blocks
        if stream is None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
        self.stream = stream
        shape = (num_layers, num_blocks, block_size, num_kv_heads)
        v_head_dim = v_head_dim or head_dim
        self.k_pool = torch.zeros(shape + (head_dim,), dtype=dtype,
                                  device=self.device)
        self.v_pool = torch.zeros(shape + (v_head_dim,), dtype=dtype,
                                  device=self.device)
        self.prefix_share = prefix_share
        self.tiered = host_cache_blocks > 0
        if self.tiered and not prefix_share:
            raise ValueError("tiered KV cache requires prefix_share=True")
        if self.tiered:
            # demote-on-evict pool: LRU pressure moves cached block content
            # through host (and optionally disk) storage via the async copy
            # engine instead of dropping it
            self._mgr: Optional[PrefixBlockManager] = TieredBlockManager(
                num_blocks, host_blocks=host_cache_blocks,
                disk_blocks=disk_cache_blocks,
                on_demote=self._on_demote, on_drop=self._on_drop)
            self._engine = copy_engine if copy_engine is not None \
                else BlockCopyEngine()
            self._own_engine = copy_engine is None
            self._copy_stream = torch.cuda.Stream(self.device) \
                if self.device.type == "cuda" else None
            self._store_lock = threading.Lock()
            # key -> (k bytes, v bytes, crc32, dtype name)
            self._host_store: Dict[int, Tuple[np.ndarray, np.ndarray, int,
                                              str]] = {}
            self._disk_index: Dict[int, str] = {}
            self._disk_dir = disk_cache_dir
            self._own_disk_dir = False
            if disk_cache_blocks > 0 and self._disk_dir is None:
                self._disk_dir = tempfile.mkdtemp(prefix="repro-torch-kv-")
                self._own_disk_dir = True
            self.host_bw, self.host_latency = host_bw, host_latency
            self.disk_bw, self.disk_latency = disk_bw, disk_latency
            self._bytes_per_token = (num_layers * num_kv_heads
                                     * (head_dim + v_head_dim)
                                     * self.k_pool.element_size())
        else:
            self._mgr = PrefixBlockManager(num_blocks) if prefix_share \
                else None
            self._engine = None
        self._free: List[int] = [] if prefix_share \
            else list(range(num_blocks))
        self._tables: Dict[int, BlockTable] = {}

    # ------------------------------------------------------------ allocation
    @property
    def free_blocks(self) -> int:
        if self._mgr is not None:
            return self._mgr.free_blocks
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained for prefix reuse (share mode only)."""
        return self._mgr.cached_blocks if self._mgr is not None else 0

    def blocks_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def can_allocate(self, num_tokens: int) -> bool:
        if self._mgr is not None:
            return self.blocks_needed(num_tokens) <= self._mgr.available()
        return self.blocks_needed(num_tokens) <= len(self._free)

    def probe(self, keys: Sequence[int]) -> int:
        """Cached-prefix length in TOKENS for a prompt whose block hash
        chain is `keys` (see `repro_torch.core.prefixcache.block_keys`).
        0 without prefix sharing."""
        if self._mgr is None:
            return 0
        return self._mgr.probe_len(keys) * self.block_size

    # -------------------------------------------------------------- tiering
    def probe_tiers(self, keys: Sequence[int]) -> Tuple[int, int, int]:
        """(warm, host, disk) cached-prefix lengths in TOKENS: the
        HBM-resident run `probe` reports, then the contiguous cold run split
        by tier. Without tiering this is (probe(keys), 0, 0)."""
        if not self.tiered:
            return (self.probe(keys), 0, 0)
        th = self._mgr.probe_tiers(keys)
        bs = self.block_size
        return (th.hbm_blocks * bs, th.host_blocks * bs, th.disk_blocks * bs)

    def promote_seconds(self, host_tokens: int, disk_tokens: int = 0) -> float:
        """Predicted wall-clock to promote that many cold tokens back into
        HBM — the copy side of the promote-vs-recompute gate (the recompute
        side is the TTFT predictor's saving)."""
        t = 0.0
        if host_tokens > 0:
            t += self.host_latency \
                + host_tokens * self._bytes_per_token / self.host_bw
        if disk_tokens > 0:
            t += self.disk_latency \
                + disk_tokens * self._bytes_per_token / self.disk_bw
        return t

    def promote_async(self, keys: Sequence[int],
                      max_blocks: Optional[int] = None) -> PromotionTicket:
        """Start promoting the cold extension of `keys`' warm run: reserve
        HBM blocks (`promote_begin`) and enqueue one verify-and-fetch copy
        job per block. Call UNDER the owner's kv lock; then `ticket.wait`
        OUTSIDE it and `promote_settle(ticket)` back under it. Every
        reserved block is settled exactly once — commit or abort."""
        if not self.tiered:
            return PromotionTicket([])
        pairs = self._mgr.promote_begin(keys, max_blocks)
        items = []
        for key, block, tier in pairs:
            job = self._engine.submit("promote", key,
                                      lambda key=key: self._fetch_cold(key))
            items.append((key, block, tier, job))
        return PromotionTicket(items)

    def _fetch_cold(self, key: int):
        """Copy-worker body: pull the key's stored bytes (host store first,
        then disk), verify the checksum, and upload them. Returns (k, v,
        event after the upload or None). Move semantics — the cold copy is
        consumed. A lost or corrupt copy raises `TierDataError`: the
        promotion aborts-with-drop and the prefill recomputes those tokens
        instead of reading stale KV."""
        with self._store_lock:
            entry = self._host_store.pop(key, None)
            path = None if entry is not None \
                else self._disk_index.pop(key, None)
        if entry is not None:
            k_raw, v_raw, crc, dtype = entry
        elif path is not None:
            try:
                with np.load(path) as z:
                    k_raw, v_raw = z["k"], z["v"]
                    crc, dtype = int(z["crc"]), str(z["dtype"])
                os.remove(path)
            except Exception as e:          # unreadable/garbled npz
                raise TierDataError(f"disk block for key {key:#x} lost: {e}")
        else:
            raise TierDataError(f"tier copy for key {key:#x} lost")
        if block_checksum(k_raw, v_raw) != crc:
            raise TierDataError(f"checksum mismatch for key {key:#x}")
        dt = getattr(torch, dtype)
        if self._copy_stream is None:
            return (torch.from_numpy(k_raw).view(dt),
                    torch.from_numpy(v_raw).view(dt), None)
        with torch.cuda.stream(self._copy_stream):
            k = torch.from_numpy(k_raw).to(self.device).view(dt)
            v = torch.from_numpy(v_raw).to(self.device).view(dt)
            return k, v, mark(self.device)

    def promote_settle(self, ticket: PromotionTicket) -> int:
        """UNDER the kv lock: commit every landed copy (write the data into
        the reserved block, re-register the key) and abort the rest — a
        failed/corrupt copy drops its tier entry (recompute fallback), a
        timed-out one returns the key to its tier for a later try. Returns
        blocks committed."""
        if not self.tiered:
            return 0
        committed = 0
        with on_stream(self.stream):
            for key, _block, _tier, job in ticket.items:
                if key not in self._mgr._promoting:
                    continue                 # settled via an earlier ticket
                if job.done.is_set() and job.error is None \
                        and job.result is not None:
                    k_new, v_new, landed = job.result
                    b = self._mgr.promote_commit(key)
                    if b is None:            # a twin re-registered the key
                        continue
                    if landed is not None:
                        # the upload ran on the copy stream: order the pool
                        # write after it, and keep its buffers alive until
                        # the pool's stream has read them
                        self.stream.wait_event(landed)
                        k_new.record_stream(self.stream)
                        v_new.record_stream(self.stream)
                    # in place, on the pool's stream, through the pool tensor
                    # itself: `grow` replaces the pools, so no view of them
                    # is kept across a call that can grow
                    self.k_pool[:, b].copy_(k_new)
                    self.v_pool[:, b].copy_(v_new)
                    committed += 1
                else:
                    corrupt = isinstance(job.error, TierDataError)
                    self._mgr.promote_abort(key, corrupt=corrupt)
        return committed

    def _on_demote(self, key: int, block: Optional[int], tier: int) -> None:
        """Manager demotion hook. HBM->host: snapshot the block's K/V NOW;
        the worker does the D2H copy + checksum off the critical path.
        Host->disk: the worker moves the host entry into an .npz file.

        The reference slices the block here, an independent buffer in JAX.
        In torch ``k_pool[:, block]`` is a VIEW, read later on the worker's
        thread: by then the block may hold the KV of the prompt that reused
        it, and a checksum over those bytes would pass. So the snapshot is
        a device clone, enqueued on the pool's stream before this hook
        returns (the manager fires it before it hands the block out again,
        and every later write to the block is enqueued behind it), with an
        event after it that the worker waits on before copying."""
        if tier == TIER_HOST:
            with on_stream(self.stream):
                k_dev = self.k_pool[:, block].clone()
                v_dev = self.v_pool[:, block].clone()
                ready = mark(self.device)

            def snap(key=key, k_dev=k_dev, v_dev=v_dev, ready=ready):
                k_np, v_np = self._to_host(k_dev, v_dev, ready)
                crc = block_checksum(k_np, v_np)
                with self._store_lock:
                    self._host_store[key] = (
                        k_np, v_np, crc, str(k_dev.dtype).removeprefix("torch."))

            self._engine.submit("demote", key, snap)
        else:
            def spill(key=key):
                with self._store_lock:
                    entry = self._host_store.pop(key, None)
                if entry is None:
                    return
                k_np, v_np, crc, dtype = entry
                path = os.path.join(self._disk_dir, f"kvblk_{key:08x}.npz")
                np.savez(path, k=k_np, v=v_np, crc=np.uint32(crc),
                         dtype=np.asarray(dtype))
                with self._store_lock:
                    self._disk_index[key] = path

            self._engine.submit("spill", key, spill)

    def _to_host(self, k_dev: torch.Tensor, v_dev: torch.Tensor,
                 ready: Optional[torch.cuda.Event]):
        """Copy-worker half of a demotion: the clones' bytes as numpy uint8
        arrays in host memory. On the card the copy waits on `ready` on the
        worker's own stream, into pinned buffers."""
        if ready is None:                    # CPU: the clones are the copy
            return raw_bytes(k_dev).numpy(), raw_bytes(v_dev).numpy()
        out = []
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            for t in (k_dev, v_dev):
                # made on the pool's stream, read on this one: the allocator
                # must not reuse its memory before the copy has run
                t.record_stream(self._copy_stream)
                src = raw_bytes(t)
                host = torch.empty(src.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(src, non_blocking=True)
                out.append(host)
        self._copy_stream.synchronize()
        return out[0].numpy(), out[1].numpy()

    def _on_drop(self, key: int, tier: int) -> None:
        """Manager drop hook: a cold entry aged out (or was corrupt) — free
        its stored data. Queued behind any pending snapshot/spill for the
        same key (single-worker FIFO), so a drop never races its own write."""
        def drop(key=key):
            with self._store_lock:
                self._host_store.pop(key, None)
                path = self._disk_index.pop(key, None)
            if path is not None:
                try:
                    os.remove(path)
                except OSError:
                    pass

        self._engine.submit("drop", key, drop)

    def tier_stats(self) -> Dict[str, int]:
        """Tier observability counters (benchmarks + tests)."""
        if not self.tiered:
            return {}
        m = self._mgr
        return {"demotions": m.demotions, "spills": m.spills,
                "promotions": m.promotions,
                "promote_aborts": m.promote_aborts,
                "tier_drops": m.tier_drops,
                "host_entries": m.host_entries,
                "disk_entries": m.disk_entries,
                "in_flight": m.in_flight,
                "copies_completed": self._engine.completed,
                "copies_failed": self._engine.failed}

    def close(self, timeout: float = 5.0) -> None:
        """Drain the copy engine, abort any promotion still in flight (its
        reserved block returns to the pool — no leaks), and clean up an
        owned disk spill directory. Safe to call twice; no-op untiered."""
        if not self.tiered:
            return
        self._engine.drain(timeout)
        if self._own_engine:
            self._engine.shutdown(wait=True)
        for key in list(self._mgr._promoting):
            self._mgr.promote_abort(key)
        if self._own_disk_dir and self._disk_dir \
                and os.path.isdir(self._disk_dir):
            shutil.rmtree(self._disk_dir, ignore_errors=True)
            self._own_disk_dir = False

    def allocate(self, seq_id: int, num_tokens: int,
                 keys: Optional[Sequence[int]] = None) -> BlockTable:
        """Allocate a sequence's block chain (LIFO from the free list). With
        prefix sharing and a hash chain (`keys`), the longest cached prefix
        is PINNED (shared blocks, refcount bumped — their KV is already in
        the pool) and only the suffix gets fresh blocks; the returned
        table's ``prefix_blocks`` / ``length`` count the tokens present."""
        need = self.blocks_needed(num_tokens)
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        if self._mgr is not None:
            hit = self._mgr.acquire(seq_id, keys or (), need)
            table = BlockTable(seq_id=seq_id,
                               blocks=self._mgr.blocks_of(seq_id),
                               length=hit * self.block_size,
                               prefix_blocks=hit)
            self._tables[seq_id] = table
            return table
        if need > len(self._free):
            raise MemoryError(f"KV pool exhausted: need {need}, "
                              f"free {len(self._free)}")
        blocks = [self._free.pop() for _ in range(need)]
        table = BlockTable(seq_id=seq_id, blocks=blocks, length=0)
        self._tables[seq_id] = table
        return table

    def insert(self, seq_id: int, keys: Sequence[int]) -> int:
        """Register a completed sequence's leading blocks in the prefix trie
        (share mode): its prompt KV becomes hittable by later prompts with
        the same hash chain. No-op without sharing. Returns blocks added."""
        if self._mgr is None:
            return 0
        return self._mgr.register(seq_id, keys)

    def grow_for(self, need_blocks: int) -> None:
        """Geometric growth backing `extend` and the decode runtime's
        admission growth: at least double the pool, clamped to `max_blocks`.
        Raises MemoryError at the cap."""
        extra = max(need_blocks, self.num_blocks)
        if self.max_blocks > 0:
            extra = min(extra, self.max_blocks - self.num_blocks)
        if extra < need_blocks:
            raise MemoryError(
                f"KV pool at max_blocks={self.max_blocks} cap "
                f"(need {need_blocks} more)")
        self.grow(extra)

    def extend(self, seq_id: int, extra_tokens: int = 1) -> BlockTable:
        """Grow a sequence (decode appends); allocates blocks on demand and
        grows the pool geometrically when the free list runs out — in share
        mode only after LRU eviction of cached blocks came up short."""
        table = self._tables[seq_id]
        target = table.length + extra_tokens
        need = self.blocks_needed(target) - len(table.blocks)
        if need <= 0:
            return table
        if self._mgr is not None:
            if self._mgr.available() < need:
                self.grow_for(need - self._mgr.available())
            table.blocks.extend(self._mgr.extend_seq(seq_id, need))
            return table
        if len(self._free) < need:
            self.grow_for(need - len(self._free))
        for _ in range(need):
            table.blocks.append(self._free.pop())
        return table

    def free(self, seq_id: int) -> None:
        """Release a sequence — in share mode a refcount DECREMENT per block:
        blocks other sequences still reference stay live, refcount-0 blocks
        registered in the trie stay CACHED (LRU-evictable), only
        unregistered ones return to the free list. Without sharing every
        block returns to the free list."""
        table = self._tables.pop(seq_id)
        if self._mgr is not None:
            self._mgr.release(seq_id)
            return
        self._free.extend(table.blocks)

    def grow(self, extra_blocks: int) -> None:
        """Append `extra_blocks` fresh blocks to the pool (live tables keep
        their indices — new blocks land at the tail of both pools).

        Unlike the reference, the copy runs on the pool's stream whichever
        thread grows the pool: on another stream the `torch.cat` could run
        before writes queued there land, and keep stale blocks."""
        if extra_blocks <= 0:
            return
        def padded(pool):
            pad = list(pool.shape)
            pad[1] = extra_blocks
            return torch.cat([pool, pool.new_zeros(pad)], dim=1)
        with on_stream(self.stream):
            self.k_pool = padded(self.k_pool)
            self.v_pool = padded(self.v_pool)
        if self._mgr is not None:
            self._mgr.grow(extra_blocks)
        else:
            self._free.extend(range(self.num_blocks,
                                    self.num_blocks + extra_blocks))
        self.num_blocks += extra_blocks

    def table(self, seq_id: int) -> Optional[BlockTable]:
        return self._tables.get(seq_id)

    def accounting(self) -> Tuple[int, int, int, int]:
        """(free, live, cached, num_blocks) — the leak-free invariant is
        free + live + cached == num_blocks. Live counts DISTINCT blocks
        reachable from tables. Share mode also runs the manager's `check`."""
        if self._mgr is not None:
            self._mgr.check()
            return (self._mgr.free_blocks, self._mgr.live_blocks,
                    self._mgr.cached_blocks, self.num_blocks)
        live = {b for t in self._tables.values() for b in t.blocks}
        return (len(self._free), len(live), 0, self.num_blocks)

    # ---------------------------------------------------- copy-on-write
    def _writable_block(self, table: BlockTable, block_index: int) -> int:
        """Block id safe to WRITE at `block_index` of `table`'s chain. In
        share mode a shared block (refcount > 1) is replaced by a fresh
        private copy (data duplicated in place — the diverging writer must
        not clobber the other readers' prefix), and an exclusively-held but
        trie-registered block is unregistered (its cached content is about
        to change). Plain mode: the block itself."""
        b = table.blocks[block_index]
        if self._mgr is None:
            return b
        nb, copied = self._mgr.make_private(table.seq_id, block_index)
        if copied:
            self.k_pool[:, nb].copy_(self.k_pool[:, b])
            self.v_pool[:, nb].copy_(self.v_pool[:, b])
            table.blocks[block_index] = nb
            if block_index < table.prefix_blocks:
                table.prefix_blocks = block_index
        return nb

    # ------------------------------------------------------------------ data
    def _index(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64), device=self.device)

    def write(self, seq_id: int, pos: int, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Write one token's K/V at absolute position pos. k/v: (L, K, hd).
        Scalar reference path; `write_tokens` is the batched equivalent.
        Both route the target block through copy-on-write."""
        table = self._tables[seq_id]
        blk = self._writable_block(table, pos // self.block_size)
        off = pos % self.block_size
        self.k_pool[:, blk, off] = k.to(self.k_pool.dtype)
        self.v_pool[:, blk, off] = v.to(self.v_pool.dtype)
        table.length = max(table.length, pos + 1)

    def write_prompt(self, seq_id: int, k: torch.Tensor, v: torch.Tensor,
                     start: int = 0) -> None:
        """Bulk write a prefilled prompt in one in-place scatter.
        k/v: (L, T, K, hd) covering positions [start, start + T); `start`
        must be block-aligned — the prefix-sharing suffix write passes
        ``start = hit_tokens`` so the pinned shared blocks are never
        written. The final partial block's tail is zero-filled (positions
        past `length` are dead: readers mask by kv_len)."""
        table = self._tables[seq_id]
        T = k.shape[1]
        if T == 0:
            return
        bs = self.block_size
        if start % bs != 0:
            raise ValueError(f"write_prompt start={start} must be a "
                             f"multiple of block_size={bs}")
        b0 = start // bs
        nb = (T + bs - 1) // bs
        if nb * bs != T:
            def padded(x):
                pad = list(x.shape)
                pad[1] = nb * bs - T
                return torch.cat([x, x.new_zeros(pad)], dim=1)
            k, v = padded(k), padded(v)
        L_ = k.shape[0]
        k = k.reshape(L_, nb, bs, *k.shape[2:])
        v = v.reshape(L_, nb, bs, *v.shape[2:])
        if self._mgr is not None:
            for bi in range(b0, b0 + nb):
                self._writable_block(table, bi)
        blocks = self._index(table.blocks[b0:b0 + nb])
        self.k_pool.index_copy_(1, blocks, k.to(self.k_pool.dtype))
        self.v_pool.index_copy_(1, blocks, v.to(self.v_pool.dtype))
        table.length = max(table.length, start + T)

    def gather(self, seq_id: int):
        """Contiguous (L, T_padded, K, hd) view via the block table, and the
        sequence's length. Scalar reference path; `gather_batch` is the
        batched equivalent. Under prefix sharing a chain interleaves shared
        and private block ids transparently."""
        table = self._tables[seq_id]
        idx = self._index(table.blocks)
        k = self.k_pool.index_select(1, idx)           # (L, nb, bs, K, hd)
        v = self.v_pool.index_select(1, idx)
        L_, nb, bs = k.shape[:3]
        k = k.reshape(L_, nb * bs, *k.shape[3:])
        v = v.reshape(L_, nb * bs, *v.shape[3:])
        return k, v, table.length

    # ------------------------------------------------- batched pool I/O
    def write_tokens(self, seq_ids: Sequence[int], positions: Sequence[int],
                     k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one token's K/V for EVERY listed sequence in one in-place
        scatter. k/v: (L, B, K, hd), row i at absolute position
        positions[i] of seq_ids[i]."""
        n = len(seq_ids)
        blk = np.empty(n, np.int64)
        off = np.empty(n, np.int64)
        for i, (sid, pos) in enumerate(zip(seq_ids, positions)):
            table = self._tables[sid]
            blk[i] = self._writable_block(table, pos // self.block_size)
            off[i] = pos % self.block_size
            table.length = max(table.length, pos + 1)
        blk_t, off_t = self._index(blk), self._index(off)
        self.k_pool[:, blk_t, off_t] = k.to(self.k_pool.dtype)
        self.v_pool[:, blk_t, off_t] = v.to(self.v_pool.dtype)

    def write_token_span(self, seq_ids: Sequence[int],
                         positions: Sequence[int], counts: Sequence[int],
                         k: torch.Tensor, v: torch.Tensor) -> None:
        """Write an S-token span per sequence in one in-place scatter, but
        COMMIT only counts[i] tokens. k/v: (L, B, S, K, hd); row i's span
        starts at absolute position positions[i] of seq_ids[i].

        Rollback by truncation: all S positions are written, but
        ``table.length`` advances only to positions[i] + counts[i]. Rejected
        draft positions sit past the committed length, where every reader
        masks by per-row kv_len, and a later step overwrites them. Rows with
        counts[i] == 0 (scratch padding) commit nothing. The caller must
        have ``extend``ed each table to cover positions[i] + S - 1.

        Padding rows all write the same scratch positions, and on the card
        `index_put_` with duplicate indices leaves the winner undefined.
        That is harmless only because the scratch sequence commits nothing
        and so is never read under a committed length."""
        n = len(seq_ids)
        S = int(k.shape[2])
        blk = np.empty((n, S), np.int64)
        off = np.empty((n, S), np.int64)
        for i, (sid, pos) in enumerate(zip(seq_ids, positions)):
            table = self._tables[sid]
            if (pos + S - 1) // self.block_size >= len(table.blocks):
                raise ValueError(
                    f"seq {sid}: span [{pos}, {pos + S}) exceeds its "
                    f"{len(table.blocks)}-block table; extend before writing")
            for s in range(S):
                blk[i, s] = self._writable_block(
                    table, (pos + s) // self.block_size)
                off[i, s] = (pos + s) % self.block_size
            if counts[i] > 0:
                table.length = max(table.length, pos + int(counts[i]))
        blk_t, off_t = self._index(blk), self._index(off)
        self.k_pool[:, blk_t, off_t] = k.to(self.k_pool.dtype)
        self.v_pool[:, blk_t, off_t] = v.to(self.v_pool.dtype)

    def gather_batch(self, seq_ids: Sequence[int], width: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Batched `gather` for the resident set: (L, B, T_pad, K, hd) views
        plus the per-row valid lengths. Rows are padded to `width` blocks
        (>= every row's block count; 0 = the max over rows) with an arbitrary
        valid block — padded positions lie past each row's length, so the
        decode step's per-row kv_len mask never reads them."""
        tabs = [self._tables[sid] for sid in seq_ids]
        need = max((len(t.blocks) for t in tabs), default=1)
        width = max(width or need, need, 1)
        filler = next((t.blocks[0] for t in tabs if t.blocks), 0)
        arr = np.full((len(tabs), width), filler, np.int64)
        for i, t in enumerate(tabs):
            if t.blocks:
                arr[i, :len(t.blocks)] = t.blocks
        idx = self._index(arr.reshape(-1))
        k = self.k_pool.index_select(1, idx)           # (L, B*nb, bs, K, hd)
        v = self.v_pool.index_select(1, idx)
        L_, bs = k.shape[0], k.shape[2]
        k = k.reshape(L_, len(tabs), width * bs, *k.shape[3:])
        v = v.reshape(L_, len(tabs), width * bs, *v.shape[3:])
        lens = np.asarray([t.length for t in tabs], np.int32)
        return k, v, lens
