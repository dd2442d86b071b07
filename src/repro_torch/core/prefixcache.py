"""Prefix-sharing block accounting: refcounts, a prefix trie over block
hashes, and LRU reuse of unreferenced cached blocks.

Production prompts share massive prefixes (system prompts, few-shot
templates, multi-turn resubmission), so a prompt's KV cache blocks are
content-addressable: block i of a prompt is identified by the HASH CHAIN
``key_i = H(key_{i-1}, tokens of block i)`` — equal chains mean equal
leading tokens, so a block written once can back every later prompt that
starts the same way. This module is the POLICY half of that idea, shared by
two owners ("evaluated is deployed", docs/ARCHITECTURE.md):

  * `repro_torch.serving.kvcache.PagedKVCache` (``prefix_share=True``) pairs it
    with the real jnp block pools — `block_keys` hashes actual token ids;
  * `repro_torch.sim.cluster.ClusterSim` uses it bare as each prefill instance's
    cache-residency model — keys come from `Request.prefix_hash`, populated
    by the trace generator.

Block lifecycle (the refcount lifecycle the leak test pins):

    FREE --acquire--> LIVE (refcount >= 1)
    LIVE --release--> FREE            (unregistered: content unreachable)
    LIVE --release--> CACHED          (registered in the trie, refcount 0:
                                       reusable by a later probe, evictable)
    CACHED --probe hit/acquire--> LIVE  (refcount bumps back up)
    CACHED --LRU eviction--> FREE       (capacity pressure only)

Eviction NEVER touches a block with refcount > 0 — a prompt mid-prefill or
mid-decode pins its blocks. Evicting a chain's parent before its child
merely truncates future probes at the hole (probe walks from the root and
stops at the first miss); the orphaned child ages out of the LRU on its own.

Conservation invariant (`check` — asserted by the hypothesis properties in
tests/test_prefix_cache.py and by the end-to-end leak tests): free +
distinct live + cached == num_blocks, with the three sets disjoint.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# chain root: the parent "key" of block 0 (any fixed value works; a non-zero
# constant keeps an all-zero token block from mapping to key 0)
_ROOT_KEY = 0x9E3779B9


def block_keys(tokens, block_size: int) -> Tuple[int, ...]:
    """Hash chain over the FULL blocks of a token-id sequence.

    Partial trailing blocks get no key: only full blocks are shareable
    (a partial block's future content depends on the suffix that completes
    it). crc32 over the raw int32 bytes, chained through the previous key,
    is deterministic across processes/versions — unlike `hash()`, which is
    salted for some types — and fast enough for the admission path.
    """
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32).reshape(-1))
    n_full = len(arr) // block_size
    keys: List[int] = []
    prev = _ROOT_KEY
    for i in range(n_full):
        blk = arr[i * block_size:(i + 1) * block_size]
        prev = zlib.crc32(blk.tobytes(), prev & 0xFFFFFFFF)
        keys.append(prev)
    return tuple(keys)


def chain_extend(parent: Sequence[int], materials: Sequence[int],
                 salt: int = 0) -> Tuple[int, ...]:
    """Extend a hash chain with synthetic per-block materials (the trace
    generator's key source — sim requests have no token ids). Deterministic
    integer mixing only; equal (parent, materials, salt) -> equal chain."""
    keys = list(parent)
    prev = keys[-1] if keys else _ROOT_KEY
    for m in materials:
        prev = zlib.crc32(np.int64(m ^ (salt << 17)).tobytes(),
                          prev & 0xFFFFFFFF)
        keys.append(prev)
    return tuple(keys)


class PrefixBlockManager:
    """Refcounted abstract block pool with a prefix trie and LRU reuse.

    Blocks are opaque ids ``0..num_blocks-1``; whatever data they name lives
    with the owner. A sequence acquires a *chain* of blocks: the longest
    registered prefix of its key chain is pinned (shared — refcount
    incremented), the rest come fresh from the free list, falling back to
    evicting least-recently-used CACHED (refcount-0, registered) blocks.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks))
        self._ref: Dict[int, int] = {}                 # live block -> refcount
        self._trie: Dict[int, int] = {}                # chain key -> block
        self._key_of: Dict[int, int] = {}              # block -> chain key
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # cached blocks
        self._held: Dict[int, List[int]] = {}          # seq -> blocks in order
        self.hits = 0                                  # blocks served shared
        self.misses = 0                                # blocks computed fresh
        self.evictions = 0

    # ------------------------------------------------------------- inventory
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks retained in the trie (reusable, evictable)."""
        return len(self._lru)

    @property
    def live_blocks(self) -> int:
        return len(self._ref)

    def available(self) -> int:
        """Blocks an allocation could obtain: free + evictable."""
        return len(self._free) + len(self._lru)

    def holds(self, seq_id: int) -> bool:
        return seq_id in self._held

    def blocks_of(self, seq_id: int) -> List[int]:
        return list(self._held[seq_id])

    def grow(self, extra_blocks: int) -> None:
        if extra_blocks <= 0:
            return
        self._free.extend(range(self.num_blocks,
                                self.num_blocks + extra_blocks))
        self.num_blocks += extra_blocks

    def check(self) -> None:
        """Assert the conservation invariant (tests; cheap enough to call
        after every operation in the hypothesis properties)."""
        live = set(self._ref)
        free = set(self._free)
        cached = set(self._lru)
        assert len(free) == len(self._free), "free list duplicate"
        assert not (live & free) and not (live & cached) \
            and not (free & cached), "block in two states"
        assert len(free) + len(live) + len(cached) == self.num_blocks, (
            f"leak: {len(free)} free + {len(live)} live + "
            f"{len(cached)} cached != {self.num_blocks}")
        for keys_b, b in self._trie.items():
            assert self._key_of.get(b) == keys_b, "trie/key_of out of sync"
        held_all = [b for bs in self._held.values() for b in bs]
        from collections import Counter
        counts = Counter(held_all)
        assert dict(counts) == self._ref, "refcounts != held references"

    # ------------------------------------------------------------------ trie
    def probe(self, keys: Sequence[int]) -> List[int]:
        """Block ids of the longest registered chain prefix of `keys`.
        Read-only except for LRU recency (a probe is a touch)."""
        out: List[int] = []
        for k in keys:
            b = self._trie.get(k)
            if b is None:
                break
            out.append(b)
            if b in self._lru:
                self._lru.move_to_end(b)
        return out

    def probe_len(self, keys: Sequence[int]) -> int:
        return len(self.probe(keys))

    # ------------------------------------------------------------ allocation
    def _incref(self, b: int) -> None:
        if b in self._lru:
            del self._lru[b]                     # cached -> live
        self._ref[b] = self._ref.get(b, 0) + 1

    def _decref(self, b: int) -> None:
        self._ref[b] -= 1
        if self._ref[b] == 0:
            del self._ref[b]
            if b in self._key_of:
                self._lru[b] = None              # live -> cached (MRU end)
            else:
                self._free.append(b)             # live -> free

    def _take_block(self) -> Optional[int]:
        """A writable fresh block: free list first, then LRU eviction of a
        cached block (its trie entry is dropped — the content is gone)."""
        if self._free:
            return self._free.pop()
        if self._lru:
            b, _ = self._lru.popitem(last=False)
            del self._trie[self._key_of.pop(b)]
            self.evictions += 1
            return b
        return None

    def acquire(self, seq_id: int, keys: Sequence[int],
                total_blocks: int) -> int:
        """Pin the longest cached chain prefix of `keys` and allocate fresh
        blocks up to `total_blocks`. Returns the hit length in blocks.
        Raises MemoryError (with every pin rolled back) when the fresh part
        cannot be satisfied even after LRU eviction."""
        if seq_id in self._held:
            raise ValueError(f"seq {seq_id} already holds blocks")
        hit = self.probe(keys)[:total_blocks]
        for b in hit:
            self._incref(b)
        fresh: List[int] = []
        for _ in range(total_blocks - len(hit)):
            b = self._take_block()
            if b is None:
                for fb in fresh:
                    del self._ref[fb]        # rollback: live -> free, not both
                    self._free.append(fb)
                for hb in reversed(hit):
                    self._decref(hb)
                raise MemoryError(
                    f"prefix pool exhausted: need {total_blocks - len(hit)} "
                    f"fresh blocks, {self.available()} obtainable")
            fresh.append(b)
            self._ref[b] = 1
        self._held[seq_id] = hit + fresh
        self.hits += len(hit)
        self.misses += len(fresh)
        return len(hit)

    def lock_prefix(self, seq_id: int, keys: Sequence[int],
                    max_blocks: Optional[int] = None) -> int:
        """Pin ONLY the cached hit (no fresh allocation) — the simulator's
        arrival-time step: the hit must survive until the prefill that
        depends on it completes. Returns hit length in blocks."""
        if seq_id in self._held:
            raise ValueError(f"seq {seq_id} already holds blocks")
        hit = self.probe(keys)
        if max_blocks is not None:
            hit = hit[:max_blocks]
        for b in hit:
            self._incref(b)
        self._held[seq_id] = list(hit)
        self.hits += len(hit)
        return len(hit)

    def extend_seq(self, seq_id: int, n_blocks: int = 1) -> List[int]:
        """Append fresh blocks to a held chain (decode growth / suffix
        allocation at completion). Raises MemoryError when unobtainable."""
        got: List[int] = []
        for _ in range(n_blocks):
            b = self._take_block()
            if b is None:
                for fb in got:
                    self._free.append(fb)
                    self._held[seq_id].remove(fb)
                    del self._ref[fb]
                raise MemoryError("prefix pool exhausted on extend")
            self._ref[b] = 1
            self._held[seq_id].append(b)
            got.append(b)
        return got

    def make_private(self, seq_id: int, index: int) -> Tuple[int, bool]:
        """Copy-on-divergence: make block `index` of the seq's chain safely
        writable. Shared (refcount > 1) -> swap in a fresh block (returns
        ``(new_block, True)`` — the owner must copy the data over);
        exclusively held but registered -> unregister (the cached content is
        about to change); already private -> no-op. Returns
        ``(block, copied)``."""
        blocks = self._held[seq_id]
        b = blocks[index]
        if self._ref[b] == 1:
            if b in self._key_of:
                del self._trie[self._key_of.pop(b)]
                if b in self._lru:               # unreachable: live, not LRU
                    del self._lru[b]
            return b, False
        nb = self._take_block()
        if nb is None:
            raise MemoryError("prefix pool exhausted on copy-on-divergence")
        self._ref[nb] = 1
        self._decref(b)
        blocks[index] = nb
        return nb, True

    def register(self, seq_id: int, keys: Sequence[int]) -> int:
        """Insert the seq's leading blocks into the trie under `keys` (the
        completion-time step: the chain's content now exists). Keys already
        registered — the pinned hit, or a concurrent identical prompt — keep
        their existing mapping. Returns blocks newly registered."""
        blocks = self._held[seq_id]
        added = 0
        for k, b in zip(keys, blocks):
            if k in self._trie or b in self._key_of:
                continue
            self._trie[k] = b
            self._key_of[b] = k
            added += 1
        return added

    def commit(self, seq_id: int, keys: Sequence[int]) -> int:
        """Simulator completion path for a `lock_prefix`-ed seq: allocate a
        residency block for each still-unregistered tail key and register it
        DIRECTLY under that key (best-effort — stop when nothing is
        obtainable), then release every pin. Keys another chain registered
        meanwhile (a twin, or a surviving orphan of an evicted parent) are
        skipped without consuming a block — registration is per-key, never
        a positional zip, so a skipped middle key cannot shift later keys
        onto the wrong block. Returns blocks newly added to the cache."""
        held = self._held[seq_id]
        hit = len(held)                           # aligned with keys[:hit]
        added = 0
        for k in keys[hit:]:
            if k in self._trie:
                continue              # that position is already served
            b = self._take_block()
            if b is None:
                break                             # capacity: cache what fits
            self._ref[b] = 1
            held.append(b)
            self._trie[k] = b
            self._key_of[b] = k
            added += 1
        self.release(seq_id)
        return added

    def release(self, seq_id: int) -> None:
        """Drop every reference the seq holds: refcount-0 registered blocks
        park in the LRU cache, unregistered ones return to the free list."""
        for b in self._held.pop(seq_id):
            self._decref(b)
