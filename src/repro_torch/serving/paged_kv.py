"""Paged KV storage (paper §4.2.2): a host block allocator and the
device-side helpers the serving path uses.

Counterpart of ``repro.serving.paged_kv``. Pool tensors are shaped

    (L, num_blocks + 1, block_size, H_kv, d_head)

with the final physical block a sentinel: unmapped block-table entries
point at it, so masked writes and reads need no dynamic shapes. Tier
membership is per-token metadata (``PAMState.tier``), so one pool holds
the blocks of every tier.
"""

from __future__ import annotations

import numpy as np
import torch


class OutOfBlocks(RuntimeError):
    """An allocation cannot be served from the free list; the engine
    treats it as admission backpressure (the request stays queued)."""


class BlockAllocator:
    """Free-list block allocator with per-sequence tables (host side).

    ``allocate(seq_id, n_tokens)`` grows ``seq_id``'s table to cover
    ``n_tokens`` logical tokens and returns it (physical ids in logical
    order); ``free`` returns a sequence's blocks to the free list. Block
    sharing (``adopt``, refcounts) comes with the prefix cache.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def occupancy(self) -> float:
        return self.used_blocks / max(self.num_blocks, 1)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        need = self.blocks_for(n_tokens) - len(self.tables.get(seq_id, []))
        if need > len(self._free):
            raise OutOfBlocks(f"need {need} blocks, {len(self._free)} free")
        tbl = self.tables.setdefault(seq_id, [])
        for _ in range(max(need, 0)):
            tbl.append(self._free.pop())
        return tbl

    def free(self, seq_id: int) -> int:
        """Return the sequence's blocks to the free list; an unknown or
        already-freed ``seq_id`` is a no-op. Returns blocks recycled."""
        tbl = self.tables.pop(seq_id, None)
        if tbl is None:
            return 0
        self._free.extend(tbl)
        return len(tbl)

    def table(self, seq_id: int) -> list[int]:
        return self.tables.get(seq_id, [])

    def padded_table(self, seq_id: int, n_logical: int,
                     sentinel: int) -> np.ndarray:
        """Device-ready table row: ``(n_logical,)`` int32, physical ids in
        logical order, ``sentinel`` for unmapped logical blocks."""
        row = np.full((n_logical,), sentinel, np.int32)
        tbl = self.tables.get(seq_id, [])
        row[:len(tbl)] = tbl
        return row


# ------------------------------------------------- device-side primitives
def token_block_mask(mask: torch.Tensor, block_size: int) -> torch.Tensor:
    """(B, S) token mask -> (B, S//block_size) "block touched" mask."""
    B, S = mask.shape
    return mask.reshape(B, S // block_size, block_size).any(dim=-1)


def write_prefill(pool: torch.Tensor, kv: torch.Tensor,
                  table_row: torch.Tensor, block_size: int) -> None:
    """Scatter one prefilled sequence into the pool through its table,
    in place.

    pool: (L, NB+1, bs, Hkv, dh); kv: (L, Hkv, S, dh) with the prompt in
    positions [0, prompt_len); table_row: (S//bs,) physical ids (sentinel
    for unmapped). Whole logical blocks are written; unmapped entries
    land in the sentinel block.
    """
    L, Hkv, S, dh = kv.shape
    blocks = torch.movedim(kv, 1, 2).reshape(L, S // block_size, block_size,
                                             Hkv, dh)
    pool[:, table_row.long()] = blocks
