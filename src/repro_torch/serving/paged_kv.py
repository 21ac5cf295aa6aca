"""Paged KV storage (paper §4.2.2): the host's refcounted block
allocator and prompt-prefix trie, the device-side helpers the serving
path uses, and ``PagedKVPool``, the pool as one object for tools and
tests (the engine holds the pool tensors itself).

Counterpart of ``repro.serving.paged_kv``. Pool tensors are shaped

    (L, num_blocks + 1, block_size, H_kv, d_head)

with the final physical block a sentinel: unmapped block-table entries
point at it, so masked writes and reads need no dynamic shapes. Tier
membership is per-token metadata (``PAMState.tier``), so one pool holds
the blocks of every tier.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.core import pam_interface as pam_if
from repro_torch.device import resolve_device


class OutOfBlocks(RuntimeError):
    """An allocation cannot be served from the free list; the engine
    treats it as admission backpressure (the request stays queued)."""


class BlockAllocator:
    """Refcounted free-list block allocator with per-sequence tables.

    Host-side only. ``allocate(seq_id, n_tokens)`` grows ``seq_id``'s
    table to cover ``n_tokens`` logical tokens (idempotent for already-
    covered prefixes) and returns the table — a list of *physical* block
    ids in logical order.

    Prefix sharing makes physical blocks REFERENCE-COUNTED: a block may
    be mapped by several live tables at once (a shared prompt prefix)
    and additionally pinned by the ``PrefixTrie``. ``free`` therefore
    DECREFS: a block returns to the free list only
    when its last reference drops. ``adopt``/``admit_shared`` map
    existing blocks into a new table (increffing them) instead of
    popping fresh ones; ``incref``/``decref`` are the raw primitives the
    trie uses for its own pins.

    Explicit failure behaviour: ``free`` of an unknown or already-freed
    ``seq_id`` is a no-op returning 0 (a double release during teardown
    must not crash the engine),
    while ``decref`` of a block with no outstanding references raises
    ``ValueError`` — that is always a real double-free bug.

    ``check_refcounts`` certifies conservation: every block's refcount
    equals its appearances across live tables plus external pins, the
    free list holds exactly the zero-ref blocks, and no table maps the
    same block twice.
    """

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}
        self.refcount: dict[int, int] = {}   # physical id -> live refs

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Blocks with at least one reference (tables OR trie pins) —
        with sharing this is NOT the sum of table lengths."""
        return self.num_blocks - len(self._free)

    @property
    def occupancy(self) -> float:
        """Fraction of the pool currently referenced. Shared blocks
        count ONCE however many tables map them, which is exactly the
        capacity win prefix sharing buys."""
        return self.used_blocks / max(self.num_blocks, 1)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def allocate(self, seq_id: int, n_tokens: int) -> list[int]:
        need = self.blocks_for(n_tokens) - len(self.tables.get(seq_id, []))
        if need > len(self._free):
            raise OutOfBlocks(
                f"need {need} blocks, {len(self._free)} free")
        tbl = self.tables.setdefault(seq_id, [])
        for _ in range(max(need, 0)):
            b = self._free.pop()
            self.refcount[b] = 1
            tbl.append(b)
        return tbl

    def adopt(self, seq_id: int, shared: list[int]) -> list[int]:
        """Map already-live physical blocks (a trie-matched prefix, in
        logical order) into ``seq_id``'s table, increffing each. The
        blocks must currently be referenced — adopting a free-listed id
        would alias recycled storage."""
        tbl = self.tables.setdefault(seq_id, [])
        for b in shared:
            self.incref(b)
            tbl.append(b)
        return tbl

    def admit_shared(self, seq_id: int, shared: list[int],
                     n_tokens: int) -> list[int]:
        """Atomic shared admission: map ``shared`` prefix blocks plus
        enough fresh blocks to cover ``n_tokens``, or raise
        ``OutOfBlocks`` with the allocator state untouched."""
        have = len(self.tables.get(seq_id, []))
        need = self.blocks_for(n_tokens) - have - len(shared)
        if need > len(self._free):
            raise OutOfBlocks(
                f"need {need} fresh blocks, {len(self._free)} free")
        self.adopt(seq_id, shared)
        return self.allocate(seq_id, n_tokens)

    def incref(self, block: int) -> None:
        if self.refcount.get(block, 0) <= 0:
            raise ValueError(f"incref of unreferenced block {block}: "
                             f"only live blocks can gain references")
        self.refcount[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; returns True iff the block hit zero refs
        and went back on the free list. Raises ``ValueError`` on a
        double-free (no outstanding references)."""
        rc = self.refcount.get(block, 0)
        if rc <= 0:
            raise ValueError(f"double free of block {block}")
        self.refcount[block] = rc - 1
        if rc == 1:
            del self.refcount[block]
            self._free.append(block)
            return True
        return False

    def free(self, seq_id: int) -> int:
        """Drop the sequence's reference on every block of its table.
        With prefix sharing this is a DECREF: blocks
        still mapped by another live request, or pinned by the trie,
        stay out of the free list. Unknown / already-freed ``seq_id`` is
        an explicit no-op. Returns the number of blocks actually
        recycled."""
        tbl = self.tables.pop(seq_id, None)
        if tbl is None:
            return 0
        return sum(self.decref(b) for b in tbl)

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

    def check_refcounts(self, extra_refs: dict[int, int] | None = None
                        ) -> bool:
        """Refcount conservation, callable from any test.

        ``extra_refs`` are references held outside the tables (pass
        ``PrefixTrie.block_refs()``). Certifies, for the whole pool:

        * per-block refcount == appearances across live tables + extras
        * no table maps the same physical block twice
        * free list ∩ referenced blocks == ∅ (and holds no duplicates)
        * every block is either referenced or free — nothing leaks
        """
        refs: collections.Counter = collections.Counter()
        for t in self.tables.values():
            if len(t) != len(set(t)):
                return False            # one table maps a block twice
            refs.update(t)
        for b, n in (extra_refs or {}).items():
            refs[b] += n
        if any(not 0 <= b < self.num_blocks for b in refs):
            return False
        free = set(self._free)
        if len(free) != len(self._free):
            return False                # duplicate free-list entry
        if free & set(refs):
            return False                # referenced block on free list
        if len(refs) + len(free) != self.num_blocks:
            return False                # leaked (or phantom) blocks
        return all(self.refcount.get(b, 0) == n for b, n in refs.items()) \
            and all(refs.get(b, 0) == n for b, n in self.refcount.items())

    def check_no_double_mapping(self,
                                extra_refs: dict[int, int] | None = None
                                ) -> bool:
        """The no-double-mapping invariant, refcount-aware: with sharing
        a block legitimately appears in several tables, so what must
        hold is refcount conservation (``check_refcounts``)."""
        return self.check_refcounts(extra_refs)


# ----------------------------------------------------------- prefix trie
def _lcp(a, b) -> int:
    """Length of the longest common prefix of two token sequences."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


@dataclasses.dataclass
class _TrieNode:
    """One cached FULL block of prompt tokens. The path root -> node
    spells the token prefix in ``block_size`` chunks; ``block`` is the
    physical pool block holding its KV. ``partials`` index cached
    partially-filled tail blocks published below this prefix: token
    tuple (shorter than a block) -> ``[physical id, lru stamp]``."""
    block: int
    children: dict = dataclasses.field(default_factory=dict)
    partials: dict = dataclasses.field(default_factory=dict)
    stamp: int = 0


class PrefixTrie:
    """Prompt-prefix cache index over the paged pool.

    Keyed on token ids at block granularity: a lookup walks full-block
    token chunks and returns the longest cached prefix plus the physical
    blocks holding its KV, so an admission maps those blocks instead of
    recomputing prefill for them. Partially-filled tail blocks are
    indexed too — a sharer may map one only via COPY-ON-WRITE (the
    engine duplicates it into a fresh block before any scatter), because
    the publisher keeps appending decode tokens into slots past the
    published fill.

    The trie holds ONE allocator reference per block it indexes, so
    cached prefixes survive their publisher finishing (that is the whole
    point of a prefix cache) yet are reclaimable: ``evict`` drops
    LRU entries whose blocks have no other reference (refcount 1 =
    trie-only), leaf-first so every surviving path stays contiguous from
    the root. The serving engine calls it when the free list cannot
    cover an admission — cache pressure degrades to recompute, never to
    failure.
    """

    def __init__(self, block_size: int, allocator: BlockAllocator):
        self.block_size = block_size
        self.allocator = allocator
        self.root = _TrieNode(block=-1)
        self._tick = 0
        self.hits = 0                   # lookups matching > 0 tokens
        self.evictions = 0              # blocks reclaimed under pressure

    # ------------------------------------------------------------- lookup
    def lookup(self, tokens) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``: returns ``(matched,
        phys_ids)`` where ``phys_ids`` cover logical blocks
        ``[0, ceil(matched / block_size))`` in order. When ``matched``
        is not a block multiple, the LAST id is a partially-covered
        block — the caller must copy-on-write it before writing."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        self._tick += 1
        node, ids, i = self.root, [], 0
        while i + bs <= len(toks):
            child = node.children.get(tuple(toks[i:i + bs]))
            if child is None:
                break
            child.stamp = self._tick
            ids.append(child.block)
            i += bs
            node = child
        # partial tail: longest common prefix with any published partial
        # OR with the leading tokens of a cached FULL block (both are
        # partially-covered matches the caller must copy-on-write)
        rest, best_len, best_blk, best_hit = toks[i:], 0, -1, None
        for ptoks, entry in node.partials.items():
            lcp = _lcp(rest, ptoks)
            if lcp > best_len:
                best_len, best_blk, best_hit = lcp, entry[0], entry
        for key, child in node.children.items():
            lcp = _lcp(rest, key)
            if lcp > best_len:
                best_len, best_blk, best_hit = lcp, child.block, child
        if best_len:
            ids.append(best_blk)
            if isinstance(best_hit, _TrieNode):
                best_hit.stamp = self._tick
            else:
                best_hit[1] = self._tick
        matched = i + best_len
        if matched:
            self.hits += 1
        return matched, ids

    # ------------------------------------------------------------ publish
    def insert(self, tokens, table: list[int]) -> int:
        """Publish an admitted prompt's blocks (call AFTER the commit
        dispatch lands their KV in the pool). ``table`` is the owner's
        physical ids in logical order. Already-cached chunks are left in
        place; each newly indexed block gains one trie reference.
        Returns the number of blocks published."""
        toks = [int(t) for t in tokens]
        bs = self.block_size
        self._tick += 1
        node, published = self.root, 0
        for j in range(len(toks) // bs):
            key = tuple(toks[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(block=table[j], stamp=self._tick)
                self.allocator.incref(table[j])
                node.children[key] = child
                published += 1
            child.stamp = self._tick
            node = child
        rem = len(toks) % bs
        if rem:
            key = tuple(toks[-rem:])
            if key not in node.partials:
                node.partials[key] = [table[len(toks) // bs], self._tick]
                self.allocator.incref(table[len(toks) // bs])
                published += 1
        return published

    # ------------------------------------------------------------ evict
    def _evictable(self):
        """(stamp, remover, block) for every entry whose block is
        trie-only (refcount 1): all partials, plus LEAF full nodes —
        interior nodes stay so surviving paths remain root-contiguous."""
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for key, entry in list(node.partials.items()):
                if self.allocator.refcount.get(entry[0], 0) == 1:
                    out.append((entry[1], (node.partials, key), entry[0]))
            for key, child in node.children.items():
                if (not child.children and not child.partials
                        and self.allocator.refcount.get(child.block,
                                                        0) == 1):
                    out.append((child.stamp, (node.children, key),
                                child.block))
                stack.append(child)
        return out

    def evict(self, need: int) -> int:
        """Reclaim at least ``need`` blocks by dropping LRU trie-only
        entries (leaf-first). Returns how many blocks were actually
        freed — fewer than ``need`` when live requests pin the rest."""
        freed = 0
        while freed < need:
            cands = self._evictable()
            if not cands:
                break
            _, (container, key), block = min(cands, key=lambda c: c[0])
            del container[key]
            freed += self.allocator.decref(block)
            self.evictions += 1
        return freed

    # ------------------------------------------------------------- stats
    def block_refs(self) -> dict[int, int]:
        """Trie-held references per block — the ``extra_refs`` operand
        of ``BlockAllocator.check_refcounts``."""
        refs: dict[int, int] = {}
        stack = [self.root]
        while stack:
            node = stack.pop()
            for entry in node.partials.values():
                refs[entry[0]] = refs.get(entry[0], 0) + 1
            for child in node.children.values():
                refs[child.block] = refs.get(child.block, 0) + 1
                stack.append(child)
        return refs

    @property
    def num_blocks(self) -> int:
        return len(self.block_refs())


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


def copy_block(pool: torch.Tensor, src, dst) -> None:
    """Copy-on-write duplicate, in place: clone physical block ``src``
    into ``dst`` for every layer.

    pool: (L, NB+1, bs, Hkv, dh); src/dst: physical ids (ints or 0-dim
    tensors). The admission commit runs it BEFORE the sharer's suffix
    scatter, so a partially-filled tail block published in the prefix
    trie is never written through a shared mapping: the publisher keeps
    appending into the original, the sharer diverges in its own copy.
    A self-copy (the sentinel onto itself) is a no-op.
    """
    pool[:, dst] = pool[:, src]


def gather_sequence(pool: torch.Tensor, table_row: torch.Tensor
                    ) -> torch.Tensor:
    """Inverse of ``write_prefill``: gather sequences' blocks back into
    the dense cache layout.

    pool: (L, NB+1, bs, Hkv, dh); table_row: (nb,) physical ids in
    logical order, or (n, nb) for n sequences (sentinel for unmapped:
    those positions gather the trash block and are masked downstream).
    Returns (L, Hkv, nb*bs, dh), or (L, n, Hkv, nb*bs, dh).
    """
    g = pool[:, table_row.long()]           # (L, [n,] nb, bs, Hkv, dh)
    *lead, nb, bs, Hkv, dh = g.shape
    return torch.movedim(g.reshape(*lead, nb * bs, Hkv, dh), -2, -3)


def sequence_to_blocks(kv: torch.Tensor, block_size: int) -> torch.Tensor:
    """Dense cache layout -> pool block layout for one batch row:
    (L, Hkv, S, dh) -> (L, S // bs, bs, Hkv, dh)."""
    L, Hkv, S, dh = kv.shape
    return torch.movedim(kv, 1, 2).reshape(L, S // block_size, block_size,
                                           Hkv, dh)


def gather_logical(pool: torch.Tensor, block_table: torch.Tensor
                   ) -> torch.Tensor:
    """Block-table gather of one layer's pool (NB+1, bs, Hkv, dh) into
    the logical dense layout (B, Hkv, nb * bs, dh) for a (B, nb) table:
    the §6.2 re-layout unit's ``paged_gather_logical``. Every entry is
    read (dead ones too); masking is the caller's."""
    return pam_if.paged_gather_logical(pool, block_table)


def shard_block_ranges(total_blocks: int, shard: int
                       ) -> list[tuple[int, int]]:
    """Physical-block ownership of a sharded engine's pool.

    The pool's block axis (``NB + 1`` physical blocks, sentinel
    included) splits evenly over the engine's sites: site ``r`` owns the
    half-open range ``[r * nb_loc, (r + 1) * nb_loc)``. Block tables keep
    global ids; a site localises an id by subtracting its range start and
    masks out blocks it does not own (``flash_decode_paged_merged`` with
    ``block_offset``), so the allocator, the trie and migration snapshots
    never see site coordinates. The sentinel (global id ``NB``) lands on
    the last site.

    ``total_blocks`` counts the sentinel (pass ``NB + 1``) and must be
    divisible by ``shard``, which ``EngineSpec.validate`` enforces.
    """
    if total_blocks % shard:
        raise ValueError(f"{total_blocks} physical blocks (sentinel "
                         f"included) do not split over {shard} shards")
    nb_loc = total_blocks // shard
    return [(r * nb_loc, (r + 1) * nb_loc) for r in range(shard)]


@dataclasses.dataclass
class PagedKVPool:
    """Paged KV storage for the memory hierarchy, as one object.

    K and V pools are shaped ``(L, num_blocks + 1, block_size, H_kv,
    d_head)``; the trailing physical block is the sentinel unmapped
    table entries point at. One pool holds the blocks of every tier
    (residency is per-token metadata), which makes an Alg. 2 migration a
    table edit. The writes return a new pool and leave this one as it
    was, as the reference's do.
    """
    k: torch.Tensor
    v: torch.Tensor
    block_size: int

    @classmethod
    def create(cls, n_layers: int, num_blocks: int, block_size: int,
               n_kv: int, d_head: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> "PagedKVPool":
        """A zeroed pool on ``device`` (CUDA unless named)."""
        shape = (n_layers, num_blocks + 1, block_size, n_kv, d_head)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   block_size=block_size)

    @property
    def num_blocks(self) -> int:
        """Allocatable blocks (the sentinel excluded)."""
        return self.k.shape[1] - 1

    @property
    def sentinel(self) -> int:
        """Physical id of the trash block unmapped table entries use."""
        return self.k.shape[1] - 1

    def write_prefill(self, layer_k: torch.Tensor, layer_v: torch.Tensor,
                      table_row: torch.Tensor) -> "PagedKVPool":
        """Scatter a prefilled sequence (dense (L, Hkv, S, dh) layout)
        into the blocks ``table_row`` ((S // bs,) physical ids) names."""
        out = PagedKVPool(self.k.clone(), self.v.clone(), self.block_size)
        write_prefill(out.k, layer_k, table_row, self.block_size)
        write_prefill(out.v, layer_v, table_row, self.block_size)
        return out

    def gather_logical(self, block_table: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Logical-order gather of every layer: K and V shaped (L, B,
        Hkv, nb * bs, dh) for a (B, nb) block table."""
        return (torch.stack([gather_logical(p, block_table) for p in self.k]),
                torch.stack([gather_logical(p, block_table) for p in self.v]))

    def _index(self, block_ids, slot_ids):
        dev = self.k.device
        return (torch.as_tensor(np.asarray(block_ids), device=dev).long(),
                torch.as_tensor(np.asarray(slot_ids), device=dev).long())

    def write_tokens(self, layer_k: torch.Tensor, layer_v: torch.Tensor,
                     block_ids: np.ndarray, slot_ids: np.ndarray
                     ) -> "PagedKVPool":
        """Scatter single tokens into (block, slot) positions: layer_k/v
        (L, T, Hkv, dh); block_ids / slot_ids (T,)."""
        bi, si = self._index(block_ids, slot_ids)
        k, v = self.k.clone(), self.v.clone()
        k[:, bi, si] = layer_k.to(k.dtype)
        v[:, bi, si] = layer_v.to(v.dtype)
        return PagedKVPool(k, v, self.block_size)

    def gather_tokens(self, block_ids: np.ndarray, slot_ids: np.ndarray
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """(L, T, Hkv, dh) K and V at the given token positions."""
        bi, si = self._index(block_ids, slot_ids)
        return self.k[:, bi, si], self.v[:, bi, si]


def token_to_block_slot(positions: np.ndarray, table: list[int],
                        block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Logical token positions -> (physical block id, slot) via a
    sequence's block table."""
    pos = np.asarray(positions)
    phys = np.asarray(table, np.int32)[pos // block_size]
    return phys, pos % block_size
