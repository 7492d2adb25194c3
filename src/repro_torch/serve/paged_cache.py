"""Paged KV cache: a shared block pool + per-request block tables.

The port of the JAX package's ``serve/paged_cache.py``.  Every attention
layer owns a pool ``k_pool/v_pool (P + 1, bs, Kv, D)`` on the device — P
blocks of bs positions each, shared by all in-flight requests, plus one
*sink* block (index P) that no table entry points to: writes that must
vanish (inactive decode slots, positions past a table) land there, since
torch has no drop mode for scatters.  Each request holds a block table row
``tbl (max_blocks,)`` mapping its logical block i to a pool block id
(-1 = unallocated) and a context length ``ctx``.  The host-side
:class:`BlockAllocator` (a copy of the JAX package's) hands out block ids
with a free list and per-block refcounts.

Absolute position p of request b lives at ``(tbl[b, p // bs], p % bs)``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


class PagedCacheError(RuntimeError):
    pass


@dataclasses.dataclass
class BlockAllocator:
    """Host-side pool bookkeeping: free list + refcounts.

    Allocation is all-or-nothing (``allocate`` returns None rather than a
    partial grant) so the scheduler can reserve a request's full footprint
    at admission and never OOM mid-flight.  ``fork`` shares fully-written
    blocks by refcount — a shared block must be treated copy-on-write by
    the caller (the engine copies the partial tail block before a forked
    request appends to it).
    """
    n_blocks: int
    block_size: int

    def __post_init__(self):
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._refs = np.zeros(self.n_blocks, dtype=np.int32)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold n_tokens positions."""
        return -(-max(n_tokens, 0) // self.block_size)

    def allocate(self, n: int) -> Optional[List[int]]:
        """Grant n blocks (refcount 1 each) or None if the pool is short."""
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._refs[out] = 1
        return out

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if self._refs[b] <= 0:
                raise PagedCacheError(f"double free of block {b}")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                self._free.append(b)

    def fork(self, blocks: List[int]) -> List[int]:
        """Share an existing chain: refcount++ on every block, same ids.

        The forked request reads the shared prefix for free; before it
        *writes* (appends into the last, partially-filled block) the
        caller must replace that block via ``copy_on_write``.
        """
        for b in blocks:
            if self._refs[b] <= 0:
                raise PagedCacheError(f"fork of unallocated block {b}")
            self._refs[b] += 1
        return list(blocks)

    def copy_on_write(self, block: int) -> Optional[int]:
        """Detach one shared block: returns a fresh private block id (the
        caller copies the pool rows device-side), or the same id if the
        block was already private, or None if the pool is exhausted."""
        if self._refs[block] <= 1:
            return block
        fresh = self.allocate(1)
        if fresh is None:
            return None
        self._refs[block] -= 1
        return fresh[0]


def init_paged_pools(cfg, n_blocks: int, block_size: int, dtype, device):
    """{'layers': [{'k_pool', 'v_pool'} per layer]}, each pool
    (n_blocks + 1, block_size, Kv, D) zeros on ``device``; the last block is
    the sink.  Every layer must be attention."""
    kv, hd = cfg.kv_heads, cfg.head_dim_
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) != "attn":
            raise PagedCacheError(
                f"paged cache requires attention-only stacks; layer {i} "
                f"is {cfg.layer_kind(i)!r}")
    shape = (n_blocks + 1, block_size, kv, hd)
    return {"layers": [
        {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
         "v_pool": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.n_layers)]}
