"""Layout transforms of the PAM interface (paper §6.2) the serving path
uses: the logical -> hot-ring re-layout of an admission commit and the
block-table gather of the paged pool into logical order.

Counterpart of ``repro.core.pam_interface.logical_to_ring`` and
``paged_gather_logical``.
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


def paged_gather_logical(pool: torch.Tensor, block_table: torch.Tensor
                         ) -> torch.Tensor:
    """Paged pool -> logical-order dense view, batched tables.

    pool: (NB, block, H, d); block_table: (B, nb) physical ids in logical
    order. Returns (B, H, nb*block, d).
    """
    g = pool[block_table.long()]                  # (B, nb, block, H, d)
    B, nb, bs, H, d = g.shape
    return torch.movedim(g, 3, 1).reshape(B, H, nb * bs, d)
