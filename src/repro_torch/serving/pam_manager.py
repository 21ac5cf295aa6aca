"""PAM KV-centric management for the serving engine (paper §6).

Counterpart of ``repro.serving.pam_manager``. Per running sequence it
holds per-token importance (eq. 7 EMA), tier residency (HBM/DDR/SSD) and
the retrieval-sparsity participation set. Each decode step:

  1. ``participation_mask``  -> which tokens are read (top-S/c + recency)
  2. model decode step       -> attention out + per-token mass S_i(j)
  3. ``observe_update``      -> EMA update, hot append, capacity cascade,
     and every ``schedule_interval`` steps Algorithm 2.

Rankings use stable sorts (ties keep index order, as ``jnp.argsort``
does). The schedule interval is decided from the host-side step count
kept in ``PAMState.step``, so no step waits on the device to decide it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import importance as imp_mod
from repro_torch.core import scheduling
from repro_torch.core.tiers import COLD, HOT, WARM
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PAMManagerConfig:
    max_tokens: int
    hot_capacity: int                # tokens per sequence on HBM
    warm_capacity: int               # tokens per sequence on DDR
    compression: int = 8             # retrieval sparsity (paper: 8x)
    recency_window: int = 32
    lam: float = imp_mod.DEFAULT_LAMBDA
    schedule_interval: int = 4       # decode steps between Alg. 2 runs
    schedule: scheduling.ScheduleConfig = scheduling.ScheduleConfig()
    use_sparsity: bool = True
    use_tiering: bool = True


class PAMState(NamedTuple):
    """Per-batch PAM bookkeeping of the serving engine.

    ``step`` counts decode steps on the host (a Python int); the rest are
    device tensors. ``block_table`` is the paged-KV mapping, (B, nb)
    physical ids written once at admission, or size 0 when dense.
    """
    importance: torch.Tensor    # (B, Smax) fp32 — eq. 7 EMA
    tier: torch.Tensor          # (B, Smax) int32 — HOT/WARM/COLD
    step: int                   # decode steps observed
    moved_tokens: torch.Tensor  # () int32 — cumulative Alg. 2 migrations
    last_hot: torch.Tensor      # (B, Smax) bool — previous participation
    block_table: torch.Tensor   # (B, Smax//bs) int32, or (0,)


def init_pam_state(batch: int, max_tokens: int, num_blocks: int = 0,
                   sentinel: int = 0, *,
                   device: str | torch.device | None = None) -> PAMState:
    """Zero state; ``num_blocks`` > 0 sizes the block table (all entries
    on the pool's ``sentinel`` block)."""
    dev = resolve_device(device)
    if num_blocks:
        table = torch.full((batch, num_blocks), sentinel, dtype=torch.int32,
                           device=dev)
    else:
        table = torch.zeros(0, dtype=torch.int32, device=dev)
    return PAMState(
        importance=torch.zeros((batch, max_tokens), device=dev),
        tier=torch.full((batch, max_tokens), COLD, dtype=torch.int32,
                        device=dev),
        step=0,
        moved_tokens=torch.zeros((), dtype=torch.int32, device=dev),
        last_hot=torch.zeros((batch, max_tokens), dtype=torch.bool,
                             device=dev),
        block_table=table)


# --------------------------------------------------------------- attention
def make_masked_decode_attn(participate: torch.Tensor):
    """Dense-cache decode attention over the participation set
    (``ops.masked_decode_attention``: ``flash_decode_merged`` and the
    mass from its scores)."""
    def d_fn(q, k_cache, v_cache, kv_lens):
        from repro_torch.kernels import ops as kops
        return kops.masked_decode_attention(q, k_cache, v_cache,
                                            participate, kv_lens)

    return d_fn


def make_paged_decode_attn(hot_mask: torch.Tensor, paged_mask: torch.Tensor,
                           block_table: torch.Tensor,
                           block_live: torch.Tensor):
    """Paged decode attention for the block-table fast path: the hot-ring
    partial (``flash_decode_merged``) merged with the warm/cold pool
    partial (``flash_decode_paged_merged``); signature ``d_fn(q, kc, vc,
    pk, pv, kv_lens) -> (out, mass)``."""
    def d_fn(q, k_cache, v_cache, pk, pv, kv_lens):
        from repro_torch.kernels import ops as kops
        return kops.paged_masked_decode_attention(
            q, k_cache, v_cache, pk, pv, block_table, hot_mask, paged_mask,
            kv_lens, block_live=block_live)

    return d_fn


def paged_participation_split(participate: torch.Tensor, tier: torch.Tensor,
                              lengths: torch.Tensor, block_size: int,
                              hot_window: int = 0):
    """Split one step's participation set by storage tier: (hot_mask,
    paged_mask, block_live). With a ring (``hot_window`` > 0) only
    in-window positions can be read from the hot tier; hot-tagged tokens
    outside it fall through to the pool."""
    from repro_torch.serving.paged_kv import token_block_mask
    B, Smax = participate.shape
    pos = torch.arange(Smax, device=participate.device)[None, :]
    live = participate & (pos < lengths[:, None])
    is_hot = tier == HOT
    if hot_window:
        is_hot = is_hot & (pos >= (lengths[:, None] - hot_window))
    hot_mask = live & is_hot
    paged_mask = live & ~is_hot
    return hot_mask, paged_mask, token_block_mask(paged_mask, block_size)


# ------------------------------------------------------- state updates
def _ranks(score: torch.Tensor) -> torch.Tensor:
    """Ascending rank of each entry per row, ties in index order (the
    reference's double stable argsort)."""
    order = torch.argsort(score, dim=-1, stable=True)
    ar = torch.arange(score.shape[-1], device=score.device)
    return torch.empty_like(order).scatter_(-1, order,
                                            ar.expand_as(order).contiguous())


def participation_mask(cfg: PAMManagerConfig, importance: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """(B, Smax) bool. Top-(len/c) by importance + recency pins."""
    B, Smax = importance.shape
    pos = torch.arange(Smax, device=importance.device)[None, :]
    valid = pos < lengths[:, None]
    if not cfg.use_sparsity:
        return valid
    budget = torch.clamp(lengths // cfg.compression, min=1)
    recent = (pos >= (lengths - cfg.recency_window)[:, None]) & valid
    score = importance.masked_fill(~valid, float("-inf"))
    score = score.masked_fill(recent, float("inf"))
    sel = (_ranks(-score) < budget[:, None]) & valid
    return sel | recent


def _enforce_capacity(imp, tier, valid, t_from: int, cap: int, t_to: int):
    """Demote lowest-importance tokens of tier ``t_from`` past ``cap``."""
    on = (tier == t_from) & valid
    count = on.sum(dim=-1, keepdim=True)
    ranks = _ranks(imp.masked_fill(~on, float("inf")))
    demote = on & (ranks < torch.clamp(count - cap, min=0))
    return torch.where(demote, torch.full_like(tier, t_to), tier)


def observe_update(cfg: PAMManagerConfig, state: PAMState,
                   scores: torch.Tensor, lengths: torch.Tensor,
                   participate: torch.Tensor) -> PAMState:
    """After a decode step: EMA update + hot append + capacity cascade
    + (every ``schedule_interval`` steps) Algorithm 2."""
    B, Smax = state.importance.shape
    dev = state.importance.device
    valid = torch.arange(Smax, device=dev)[None, :] < lengths[:, None]
    imp = imp_mod.update_importance(
        state.importance, torch.where(valid, scores, torch.zeros_like(scores)),
        lam=cfg.lam)
    # the new token (index lengths-1 after the append) enters HOT, seeded
    # with the row's current max importance (recency prior)
    bidx = torch.arange(B, device=dev)
    new_pos = torch.clamp(lengths - 1, min=0).long()
    tier = state.tier.clone()
    tier[bidx, new_pos] = HOT
    imp[bidx, new_pos] = torch.maximum(imp[bidx, new_pos],
                                       torch.amax(imp, dim=-1))
    moved = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.use_tiering:
        tier = _enforce_capacity(imp, tier, valid, HOT, cfg.hot_capacity,
                                 WARM)
        tier = _enforce_capacity(imp, tier, valid, WARM, cfg.warm_capacity,
                                 COLD)
        if (state.step + 1) % cfg.schedule_interval == 0:
            tier, moved_mask, _ = scheduling.schedule_kv(imp, tier, valid,
                                                         cfg.schedule)
            moved = moved_mask.sum().to(torch.int32)
    return PAMState(importance=imp, tier=tier, step=state.step + 1,
                    moved_tokens=state.moved_tokens + moved,
                    last_hot=participate, block_table=state.block_table)


def place_prefill_state(cfg: PAMManagerConfig, state: PAMState, slot: int,
                        length: int,
                        table_row: torch.Tensor | None = None) -> PAMState:
    """Initial placement for one admitted sequence, written in place
    (recency fill-down, §4.3): tail -> HOT, middle -> DDR, head -> SSD;
    ``table_row`` installs the sequence's block table."""
    Smax = state.importance.shape[1]
    idx = torch.arange(Smax, device=state.importance.device)
    valid = idx < length
    dist = torch.clamp(length - 1 - idx, min=0)
    tier = torch.where(dist < cfg.hot_capacity, HOT,
                       torch.where(dist < cfg.hot_capacity
                                   + cfg.warm_capacity, WARM, COLD))
    imp = torch.where(valid, 1.0 / (1.0 + dist.float()),
                      torch.zeros((), device=idx.device))
    state.importance[slot] = imp
    state.tier[slot] = tier.to(torch.int32)
    state.last_hot[slot] = False
    if table_row is not None:
        state.block_table[slot] = table_row
    return state


def tier_read_counts_of(tier: torch.Tensor, participate: torch.Tensor
                        ) -> torch.Tensor:
    """(3,) tokens read per tier this step."""
    return torch.stack([torch.sum(participate & (tier == t))
                        for t in (HOT, WARM, COLD)]).to(torch.int32)


def hit_rate_of(last_hot: torch.Tensor, participate: torch.Tensor
                ) -> torch.Tensor:
    """Fraction of this step's working set also in the previous one."""
    inter = torch.sum(last_hot & participate, dim=-1)
    denom = torch.clamp(torch.sum(participate, dim=-1), min=1)
    return torch.mean(inter / denom)
