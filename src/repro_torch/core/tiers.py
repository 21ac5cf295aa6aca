"""Memory-tier ids, the tiers' physical constants and the hot-window
clamp (paper §4.1, Table 1).

Counterpart of the parts of ``repro.core.tiers`` the serving path and
the perf model use. A ``TierSpec`` holds what the paper's simulator
uses: capacity, read bandwidth available to attention (aggregate PIM
bandwidth), near-memory compute throughput, and the inter-tier link
bandwidth used for KV migration; the constants are Table 1 / §7.1's.
"""

from __future__ import annotations

import dataclasses

import torch

HOT, WARM, COLD = 0, 1, 2
TIER_NAMES = ("hbm", "ddr", "ssd")


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    capacity_bytes: float          # KV capacity of this tier
    read_bw: float                 # aggregate near-memory read bandwidth B/s
    compute_flops: float           # near-memory compute throughput FLOP/s
    link_bw: float                 # migration bandwidth to adjacent tier B/s
    energy_pj_per_byte: float      # access energy (for Fig. 11 benchmark)

    def attention_time(self, bytes_read: float, flops: float) -> float:
        """Roofline time for a local-attention pass on this tier."""
        return max(bytes_read / self.read_bw, flops / self.compute_flops)

    @property
    def effective_bw(self) -> float:
        """Attention-effective bandwidth: decode attention does ~1 flop per
        KV byte, so the tier runs at min(read bw, PU flops)."""
        return min(self.read_bw, self.compute_flops)


# Paper Table-1-derived NODE-level defaults (40xHBM, 40xDDR, 64ch SSD).
# read_bw = aggregate near-bank/controller bandwidth (AttAcc-style 9x over
# a DGX's 16 TB/s for HBM-PIM); compute = power-capped PU throughput
# (1.6T/204G/18G FLOPS per device, §7.1) — decode attention at ~1 flop/byte
# is COMPUTE-capped on HBM-PIM and bandwidth-capped on SSD-PIM.
HBM_PIM = TierSpec("hbm", capacity_bytes=640e9, read_bw=144e12,
                   compute_flops=40 * 1.6e12, link_bw=64e9,
                   energy_pj_per_byte=3.5)
DDR_PIM = TierSpec("ddr", capacity_bytes=1280e9, read_bw=8.2e12,
                   compute_flops=40 * 204e9, link_bw=32e9,
                   energy_pj_per_byte=15.0)
SSD_PIM = TierSpec("ssd", capacity_bytes=8e12, read_bw=100e9,
                   compute_flops=64 * 18e9, link_bw=8e9,
                   energy_pj_per_byte=60.0)


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
