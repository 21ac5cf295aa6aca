"""Memory tiers of the PAM hierarchy (paper §4.1, Table 1).

Counterpart of ``repro.core.tiers``. A ``TierSpec`` holds what the
paper's simulator uses: capacity, read bandwidth available to attention
(aggregate PIM bandwidth), near-memory compute throughput, and the
inter-tier link bandwidth used for KV migration; the constants are
Table 1 / §7.1's. ``TieredKVState`` is one sequence's token -> tier
residency and importance (a dataclass of tensors);
``initial_placement`` its fill-down placement after prefill; and
``block_residency`` / ``blocks_per_tier`` the paged pool's per-block
view of it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.device import resolve_device

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

DEFAULT_TIERS: tuple[TierSpec, ...] = (HBM_PIM, DDR_PIM, SSD_PIM)


@dataclasses.dataclass
class TieredKVState:
    """Per-sequence token -> tier residency and importance.

    tier_of_token: (max_tokens,) int32 in {HOT, WARM, COLD}
    importance:    (max_tokens,) float32, the eq. (7) EMA
    valid:         (max_tokens,) bool, the token exists
    """
    tier_of_token: torch.Tensor
    importance: torch.Tensor
    valid: torch.Tensor

    @classmethod
    def create(cls, max_tokens: int,
               device: str | torch.device | None = None) -> "TieredKVState":
        """An empty state on ``device`` (CUDA unless named)."""
        dev = resolve_device(device)
        return cls(
            tier_of_token=torch.zeros(max_tokens, dtype=torch.int32,
                                      device=dev),
            importance=torch.zeros(max_tokens, dtype=torch.float32,
                                   device=dev),
            valid=torch.zeros(max_tokens, dtype=torch.bool, device=dev))

    @property
    def max_tokens(self) -> int:
        return self.tier_of_token.shape[0]

    def tokens_on_tier(self, tier: int) -> torch.Tensor:
        return torch.sum((self.tier_of_token == tier) & self.valid)

    def tier_counts(self, num_tiers: int = 3) -> torch.Tensor:
        """(num_tiers,) int32 count of valid tokens per tier."""
        return torch.zeros(num_tiers, dtype=torch.int32,
                           device=self.valid.device).index_add(
            0, self.tier_of_token.long(), self.valid.to(torch.int32))


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


def block_residency(tier_of_token: torch.Tensor, valid: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Per-block tier residency of the paged pool view.

    tier_of_token/valid: (..., tokens), ``tokens % block_size == 0``.
    Returns (..., tokens // block_size) int32: the hottest (minimum) tier
    among a block's valid tokens, COLD for an empty block.
    """
    t = torch.where(valid, tier_of_token,
                    torch.full_like(tier_of_token, COLD))
    t = t.reshape(t.shape[:-1] + (-1, block_size))
    return torch.amin(t, dim=-1).to(torch.int32)


def blocks_per_tier(tier_of_token: torch.Tensor, valid: torch.Tensor,
                    block_size: int, num_tiers: int = 3) -> torch.Tensor:
    """(num_tiers,) count of occupied pool blocks resident on each tier
    (per-tier page populations, paper Table 1)."""
    res = block_residency(tier_of_token, valid, block_size)
    occupied = valid.reshape(valid.shape[:-1] + (-1, block_size)).any(-1)
    return torch.stack([torch.sum((res == t) & occupied)
                        for t in range(num_tiers)])


def initial_placement(num_tokens: int, max_tokens: int,
                      tier_capacity_tokens: Sequence[int],
                      device: str | torch.device | None = None
                      ) -> TieredKVState:
    """Fill-down placement after prefill (§4.3): the newest
    ``tier_capacity_tokens[0]`` tokens on HBM, the next
    ``tier_capacity_tokens[1]`` on DDR, the rest on SSD; importance the
    recency prior 1 / (1 + distance from the tail). On ``device`` (CUDA
    unless named)."""
    idx = torch.arange(max_tokens, device=resolve_device(device))
    valid = idx < num_tokens
    dist = torch.clamp(num_tokens - 1 - idx, min=0)
    cap_h, cap_d = tier_capacity_tokens[0], tier_capacity_tokens[1]
    tier = torch.where(dist < cap_h, HOT,
                       torch.where(dist < cap_h + cap_d, WARM, COLD))
    imp = torch.where(valid, 1.0 / (1.0 + dist.float()),
                      torch.zeros((), device=idx.device))
    return TieredKVState(tier_of_token=tier.to(torch.int32), importance=imp,
                         valid=valid)
