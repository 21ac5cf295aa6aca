"""Inter-device PAM interface (paper §6.2): layout-aware KV migration
and the layout transforms between the tiers.

Counterpart of ``repro.core.pam_interface``. Each tier stores KV in its
own layout (hot: dense or bank-interleaved; warm / cold: paged blocks),
so moving tokens between tiers is a re-layout. The paper offloads it to
hardware: a command reorder unit (sender) streams tokens in destination
order and an address generation unit (receiver) issues the writes, with
no host round trip. Here a migration is one gather and one scatter with
indices precomputed by ``make_migration_plan``; with every tier in one
shared paged pool it degenerates to a tag edit (``migrate_tier_tags``).

The serving path uses the logical -> hot-ring re-layout of an admission
commit (``logical_to_ring``), its inverse for a migration export
(``ring_to_logical``), the block-table gather (``paged_gather_logical``)
and the gather of a cached prompt prefix (``gather_prefix_logical``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MigrationPlan(NamedTuple):
    """Precomputed index plan for one inter-tier transfer."""
    src_token_idx: torch.Tensor   # (n,) token slots to read from the source
    dst_token_idx: torch.Tensor   # (n,) slots to write in the destination
    count: torch.Tensor           # () live entries (<= n)


def make_migration_plan(moved_mask: torch.Tensor,
                        src_slot_of_token: torch.Tensor,
                        dst_free_slots: torch.Tensor) -> MigrationPlan:
    """Command-reorder step: the moved tokens in streaming order.

    moved_mask: (tokens,) bool, tokens leaving the source tier;
    src_slot_of_token: (tokens,) physical slot of each token in the
    source pool; dst_free_slots: (n,) free destination slots, n <=
    tokens. Moved tokens stream in ascending source slot (sequential
    reads on the sender, ties in token order); the plan is padded to n,
    entries past ``count`` reading token 0 into slot 0 but masked on
    the scatter.
    """
    n = dst_free_slots.shape[0]
    key = torch.where(moved_mask, src_slot_of_token,
                      torch.full_like(src_slot_of_token, 2 ** 30))
    order = torch.argsort(key, stable=True)
    count = torch.clamp(torch.sum(moved_mask), max=n)
    live = torch.arange(n, device=order.device) < count
    return MigrationPlan(
        src_token_idx=torch.where(live, order[:n], torch.zeros_like(
            order[:n])),
        dst_token_idx=torch.where(live, dst_free_slots.long(),
                                  torch.zeros_like(order[:n])),
        count=count)


def apply_migration(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                    plan: MigrationPlan,
                    src_slot_of_token: torch.Tensor) -> torch.Tensor:
    """Receiver step: gather the plan's tokens from the source layout
    and scatter them into a copy of the destination.

    src_pool: (src_slots, H, d); dst_pool: (dst_slots, H, d). Returns the
    updated destination pool. Only the ``count`` live entries are
    written, so a live write to slot 0 lands (the reference's masked
    scatter also rewrites slot 0 for each padding entry, after the live
    ones, and so undoes such a write).
    """
    live = torch.arange(plan.dst_token_idx.shape[0],
                        device=dst_pool.device) < plan.count
    src_slots = src_slot_of_token[plan.src_token_idx[live]].long()
    out = dst_pool.clone()
    out[plan.dst_token_idx[live]] = src_pool[src_slots].to(out.dtype)
    return out


def migrate_tier_tags(tier: torch.Tensor, moved_mask: torch.Tensor,
                      dst_tier) -> torch.Tensor:
    """Zero-copy migration: re-tag the ``moved_mask`` tokens as
    ``dst_tier`` (an int or tier ids broadcastable to ``tier``). With a
    shared paged pool this is the whole transfer: no KV byte moves."""
    dst = torch.as_tensor(dst_tier, dtype=tier.dtype, device=tier.device)
    return torch.where(moved_mask, dst, tier)


def logical_to_ring(kv: torch.Tensor, ring_pos: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Re-layout one sequence's logical KV onto ring coordinates.

    kv: (..., S, dh) absolute-position layout; ring_pos/valid: (W,) from
    ``ring_position_map``. Returns (..., W, dh): slot j holds position
    ring_pos[j], dead slots zeroed.
    """
    idx = ring_pos.clamp(0, kv.shape[-2] - 1)
    g = torch.index_select(kv, kv.dim() - 2, idx)
    return torch.where(valid[:, None], g, torch.zeros((), dtype=kv.dtype,
                                                      device=kv.device))


def ring_to_logical(ring_kv: torch.Tensor, ring_pos: torch.Tensor,
                    valid: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Scatter one sequence's ring-resident KV back into the absolute-
    position layout on top of ``base`` (the pool gather, so every other
    position keeps its capacity-tier bytes): the migration export's half
    of the ring interface.

    ring_kv: (..., W, dh); ring_pos: (W,) from ``ring_position_map``;
    valid: (W,) bool, the slots to write back (live, distinct
    positions); base: (..., S, dh). Returns a new (..., S, dh) tensor.
    """
    out = base.clone()
    out[..., ring_pos[valid], :] = ring_kv[..., valid, :]
    return out


def paged_gather_logical(pool: torch.Tensor, block_table: torch.Tensor
                         ) -> torch.Tensor:
    """Paged pool -> logical-order dense view, batched tables.

    pool: (NB, block, H, d); block_table: (B, nb) physical ids in logical
    order. Returns (B, H, nb*block, d).
    """
    g = pool[block_table.long()]                  # (B, nb, block, H, d)
    B, nb, bs, H, d = g.shape
    return torch.movedim(g, 3, 1).reshape(B, H, nb * bs, d)


def gather_prefix_logical(pool: torch.Tensor, table_row: torch.Tensor,
                          prefix_len) -> torch.Tensor:
    """The sharer-side re-layout of a prefix-cache admission: gather a
    request's cached prefix from the shared pool into the logical dense
    layout, zeroed past ``prefix_len``.

    pool: (L, NB+1, bs, Hkv, dh); table_row: (nb,) physical ids in
    logical order (sentinel for unmapped); prefix_len: cached tokens (an
    int or a 0-dim tensor). A pure read: shared blocks are never written
    through this path. Returns (L, Hkv, nb*bs, dh). A batch of n
    requests may pass (n, nb) tables and (n,) lengths and gets (L, n,
    Hkv, nb*bs, dh).
    """
    g = pool[:, table_row.long()]           # (L, [n,] nb, bs, Hkv, dh)
    *lead, nb, bs, Hkv, dh = g.shape
    seq = torch.movedim(g.reshape(*lead, nb * bs, Hkv, dh), -2, -3)
    if isinstance(prefix_len, torch.Tensor):
        prefix_len = prefix_len[..., None]
    live = torch.arange(nb * bs, device=pool.device) < prefix_len
    return torch.where(live[..., None, :, None], seq,
                       torch.zeros((), dtype=seq.dtype, device=seq.device))


def promote_block_to_ring(ring_kv: torch.Tensor, pool: torch.Tensor,
                          table_row: torch.Tensor, position,
                          block_size: int, window: int) -> torch.Tensor:
    """Promotion: copy token ``position`` from its mapped pool block into
    its ring slot (``position % window``) of a copy of the ring.

    ring_kv: (L, Hkv, W, dh) one sequence's ring; pool: (L, NB+1, bs,
    Hkv, dh); table_row: (nb,) physical ids; position: an int or a 0-dim
    tensor, an in-window position.
    """
    blk = table_row[position // block_size]
    tok = pool[:, blk, position % block_size]            # (L, Hkv, dh)
    out = ring_kv.clone()
    out[:, :, position % window, :] = tok
    return out


def paged_to_dense(pool: torch.Tensor, block_table: torch.Tensor,
                   block_size: int) -> torch.Tensor:
    """Paged blocks -> contiguous dense: pool (nblocks, block, H, d),
    block_table (nlogical,) physical ids in logical order; returns
    (nlogical * block, H, d)."""
    return pool[block_table.long()].reshape((-1,) + pool.shape[2:])


def dense_to_paged(dense: torch.Tensor, pool: torch.Tensor,
                   block_table: torch.Tensor, block_size: int
                   ) -> torch.Tensor:
    """Contiguous dense -> paged blocks (the inverse), into a copy of
    ``pool``."""
    out = pool.clone()
    out[block_table.long()] = dense.reshape((-1, block_size)
                                            + dense.shape[1:])
    return out


def bank_interleave(dense: torch.Tensor, assign: torch.Tensor,
                    num_groups: int, group_cap: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense tokens -> the (G, Tg, ...) bank-group-interleaved layout of
    the §6.1 mapping: token i goes to group ``assign[i]`` at its rank
    among that group's tokens (capped at ``group_cap - 1``). Returns
    (interleaved, slot_of_token)."""
    onehot = F.one_hot(assign.long(), num_groups)          # (n, G)
    rank = torch.cumsum(onehot, dim=0) - onehot
    rank_in_group = torch.gather(rank, 1, assign.long()[:, None])[:, 0]
    slot = assign.long() * group_cap + torch.clamp(rank_in_group,
                                                   max=group_cap - 1)
    out = torch.zeros((num_groups * group_cap,) + dense.shape[1:],
                      dtype=dense.dtype, device=dense.device)
    out[slot] = dense
    return out.reshape((num_groups, group_cap) + dense.shape[1:]), slot
