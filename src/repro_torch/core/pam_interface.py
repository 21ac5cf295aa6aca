"""Layout transforms of the PAM interface (paper §6.2) the serving path
uses: the logical -> hot-ring re-layout of an admission commit, the
block-table gather of the paged pool into logical order, and the gather
of a cached prompt prefix for a prefix-cache admission.

Counterpart of ``repro.core.pam_interface.logical_to_ring``,
``ring_to_logical``, ``paged_gather_logical`` and
``gather_prefix_logical``.
"""

from __future__ import annotations

import torch


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
