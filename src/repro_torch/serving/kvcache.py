"""Paged KV cache manager (vLLM-style block tables) on torch tensors.

The decode instance allocates cache blocks per sequence from a shared pool;
`gather` materializes a contiguous (T, K, hd) view per layer, and the
continuous-batching decode runtime uses the batched pool I/O:

  * ``write_tokens(seq_ids, positions, k, v)`` — one in-place `index_put_`
    writes every resident stream's new token per step.
  * ``gather_batch(seq_ids, width)`` — one `index_select` materializes the
    whole resident set as (L, B, T_pad, K, hd) dense views for the batched
    decode step, rows padded to a common block count.

Counterpart of src/repro/serving/kvcache.py in its plain mode: the
reference's donated jitted scatters and gathers become in-place writes and
index selects on the pool tensors. Prefix sharing and the host/disk tiers
are not ported yet; asking for either raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["BlockTable", "PagedKVCache"]


@dataclass
class BlockTable:
    seq_id: int
    blocks: List[int] = field(default_factory=list)
    length: int = 0                      # tokens currently stored


class PagedKVCache:
    """Block pool shared by all sequences on one instance.

    Storage layout: k/v pools of shape (L, num_blocks, block_size, K, hd)
    on `device`. ``max_blocks`` caps `extend`'s geometric pool growth
    (0 = unbounded).
    """

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int,
                 dtype: torch.dtype = torch.float32, *, device="cuda",
                 prefix_share: bool = False, max_blocks: int = 0,
                 host_cache_blocks: int = 0, disk_cache_blocks: int = 0):
        if prefix_share or host_cache_blocks or disk_cache_blocks:
            raise NotImplementedError(
                "prefix sharing and KV tiers are not ported yet")
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks = max_blocks
        shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(num_blocks))
        self._tables: Dict[int, BlockTable] = {}

    # ------------------------------------------------------------ allocation
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_needed(self, num_tokens: int) -> int:
        return (num_tokens + self.block_size - 1) // self.block_size

    def can_allocate(self, num_tokens: int) -> bool:
        return self.blocks_needed(num_tokens) <= len(self._free)

    def allocate(self, seq_id: int, num_tokens: int) -> BlockTable:
        """Allocate a sequence's block chain (LIFO from the free list)."""
        need = self.blocks_needed(num_tokens)
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        if need > len(self._free):
            raise MemoryError(f"KV pool exhausted: need {need}, "
                              f"free {len(self._free)}")
        blocks = [self._free.pop() for _ in range(need)]
        table = BlockTable(seq_id=seq_id, blocks=blocks, length=0)
        self._tables[seq_id] = table
        return table

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
        grows the pool geometrically when the free list runs out."""
        table = self._tables[seq_id]
        target = table.length + extra_tokens
        need = self.blocks_needed(target) - len(table.blocks)
        if need <= 0:
            return table
        if len(self._free) < need:
            self.grow_for(need - len(self._free))
        for _ in range(need):
            table.blocks.append(self._free.pop())
        return table

    def free(self, seq_id: int) -> None:
        """Release a sequence: every block returns to the free list."""
        table = self._tables.pop(seq_id)
        self._free.extend(table.blocks)

    def grow(self, extra_blocks: int) -> None:
        """Append `extra_blocks` fresh blocks to the pool (live tables keep
        their indices — new blocks land at the tail of both pools)."""
        if extra_blocks <= 0:
            return
        pad = list(self.k_pool.shape)
        pad[1] = extra_blocks
        zeros = torch.zeros(pad, dtype=self.k_pool.dtype, device=self.device)
        self.k_pool = torch.cat([self.k_pool, zeros], dim=1)
        self.v_pool = torch.cat([self.v_pool, zeros], dim=1)
        self._free.extend(range(self.num_blocks,
                                self.num_blocks + extra_blocks))
        self.num_blocks += extra_blocks

    def table(self, seq_id: int) -> Optional[BlockTable]:
        return self._tables.get(seq_id)

    def accounting(self) -> Tuple[int, int, int, int]:
        """(free, live, cached, num_blocks) — the leak-free invariant is
        free + live + cached == num_blocks. Live counts DISTINCT blocks
        reachable from tables."""
        live = {b for t in self._tables.values() for b in t.blocks}
        return (len(self._free), len(live), 0, self.num_blocks)

    # ------------------------------------------------------------------ data
    def _index(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int64), device=self.device)

    def write(self, seq_id: int, pos: int, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Write one token's K/V at absolute position pos. k/v: (L, K, hd).
        Scalar reference path; `write_tokens` is the batched equivalent."""
        table = self._tables[seq_id]
        blk = table.blocks[pos // self.block_size]
        off = pos % self.block_size
        self.k_pool[:, blk, off] = k.to(self.k_pool.dtype)
        self.v_pool[:, blk, off] = v.to(self.v_pool.dtype)
        table.length = max(table.length, pos + 1)

    def write_prompt(self, seq_id: int, k: torch.Tensor, v: torch.Tensor,
                     start: int = 0) -> None:
        """Bulk write a prefilled prompt in one in-place scatter.
        k/v: (L, T, K, hd) covering positions [start, start + T); `start`
        must be block-aligned. The final partial block's tail is zero-filled
        (positions past `length` are dead: readers mask by kv_len)."""
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
            pad = list(k.shape)
            pad[1] = nb * bs - T
            k = torch.cat([k, k.new_zeros(pad)], dim=1)
            v = torch.cat([v, v.new_zeros(pad)], dim=1)
        L_ = k.shape[0]
        k = k.reshape(L_, nb, bs, *k.shape[2:])
        v = v.reshape(L_, nb, bs, *v.shape[2:])
        blocks = self._index(table.blocks[b0:b0 + nb])
        self.k_pool.index_copy_(1, blocks, k.to(self.k_pool.dtype))
        self.v_pool.index_copy_(1, blocks, v.to(self.v_pool.dtype))
        table.length = max(table.length, start + T)

    def gather(self, seq_id: int):
        """Contiguous (L, T_padded, K, hd) view via the block table, and the
        sequence's length. Scalar reference path; `gather_batch` is the
        batched equivalent."""
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
            blk[i] = table.blocks[pos // self.block_size]
            off[i] = pos % self.block_size
            table.length = max(table.length, pos + 1)
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
