"""Memory-tier ids and the hot-window clamp (paper §4.1).

Counterpart of the parts of ``repro.core.tiers`` the serving path uses.
"""

from __future__ import annotations

import torch

HOT, WARM, COLD = 0, 1, 2
TIER_NAMES = ("hbm", "ddr", "ssd")


def clamp_hot_to_window(tier: torch.Tensor, lengths: torch.Tensor,
                        window: int) -> torch.Tensor:
    """Demote HOT tokens that slid out of the hot-window ring.

    Only the last ``window`` positions of a sequence have ring storage; a
    HOT tag at ``p < lengths - window`` is stale (the append that evicted
    the token overwrote its slot) and becomes WARM. tier: (B, S) int32;
    lengths: (B,). Returns the clamped tags.
    """
    pos = torch.arange(tier.shape[1], device=tier.device)[None, :]
    out_of_window = pos < (lengths[:, None] - window)
    return torch.where(out_of_window & (tier == HOT),
                       torch.full_like(tier, WARM), tier)
