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


def make_masked_latent_attn(participate: torch.Tensor):
    """MLA flavour: absorbed attention over the participating latent
    tokens (plain tensor code, as the reference's einsums); signature
    ``mla_latent_decode_attn``'s. The mass is the head-mean probability
    times the live count (not ``kv_lens``, as the unmasked one)."""
    def l_fn(q_eff, kv_latent, k_rope, kv_lens, *, scale):
        from repro_torch.models.mla import latent_attention
        Smax = kv_latent.shape[1]
        live = ((torch.arange(Smax, device=q_eff.device)[None, :]
                 < kv_lens[:, None]) & participate)
        out, p = latent_attention(q_eff, kv_latent, k_rope, live, scale)
        n_live = torch.sum(live, dim=-1, keepdim=True).float()
        return out, torch.mean(p, dim=1) * n_live

    return l_fn


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


def _observed(cfg: PAMManagerConfig, state: PAMState, scores: torch.Tensor,
              lengths: torch.Tensor, schedule: bool
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's (importance, tier, Alg. 2 moves ``()`` int32) after a
    decode step; ``schedule`` runs Alg. 2 (with tiering on)."""
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
    # a tensor value: a Python scalar would be copied from the host
    tier[bidx, new_pos] = torch.full_like(new_pos, HOT, dtype=tier.dtype)
    imp[bidx, new_pos] = torch.maximum(imp[bidx, new_pos],
                                       torch.amax(imp, dim=-1))
    moved = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.use_tiering:
        tier = _enforce_capacity(imp, tier, valid, HOT, cfg.hot_capacity,
                                 WARM)
        tier = _enforce_capacity(imp, tier, valid, WARM, cfg.warm_capacity,
                                 COLD)
        if schedule:
            tier, moved_mask, _ = scheduling.schedule_kv(imp, tier, valid,
                                                         cfg.schedule)
            moved = moved_mask.sum().to(torch.int32)
    return imp, tier, moved


def runs_schedule(cfg: PAMManagerConfig, step: int) -> bool:
    """Whether Alg. 2 runs in the decode step that follows ``step``
    observed ones (the reference's ``lax.cond`` predicate)."""
    return cfg.use_tiering and (step + 1) % cfg.schedule_interval == 0


def observe_update(cfg: PAMManagerConfig, state: PAMState,
                   scores: torch.Tensor, lengths: torch.Tensor,
                   participate: torch.Tensor) -> PAMState:
    """After a decode step: EMA update + hot append + capacity cascade
    + (every ``schedule_interval`` steps) Algorithm 2."""
    imp, tier, moved = _observed(cfg, state, scores, lengths,
                                 runs_schedule(cfg, state.step))
    return PAMState(importance=imp, tier=tier, step=state.step + 1,
                    moved_tokens=state.moved_tokens + moved,
                    last_hot=participate, block_table=state.block_table)


def observe_update_(cfg: PAMManagerConfig, state: PAMState,
                    scores: torch.Tensor, lengths: torch.Tensor,
                    participate: torch.Tensor, *, schedule: bool
                    ) -> torch.Tensor:
    """``observe_update`` in place, safe to capture in a CUDA graph: the
    same importance, tier and previous participation are copied into
    the tensors ``state`` holds (their storage never changes) and the
    step's moves are added to ``moved_tokens``. ``schedule`` (a static
    bool, ``runs_schedule`` of the host step count) says whether Alg. 2
    runs: the reference's ``lax.cond`` at
    ``repro/serving/pam_manager.py:239-240``, resolved when the step is
    built. ``state.step`` is the caller's to advance. Returns this
    step's moves (``()`` int32)."""
    imp, tier, moved = _observed(cfg, state, scores, lengths, schedule)
    state.importance.copy_(imp)
    state.tier.copy_(tier)
    state.last_hot.copy_(participate)
    state.moved_tokens.add_(moved)
    return moved


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


def extract_slot_state(state: PAMState, slot: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sequence's migratable PAM state: (importance, tier, last_hot)
    rows. The block table row stays behind: physical block ids are
    device-local and the importing engine's allocator rebuilds them."""
    return (state.importance[slot], state.tier[slot], state.last_hot[slot])


def insert_slot_state(state: PAMState, slot: int, importance: torch.Tensor,
                      tier: torch.Tensor, last_hot: torch.Tensor,
                      table_row: torch.Tensor | None = None) -> PAMState:
    """Install one migrated sequence's PAM rows at ``slot``, in place
    (the inverse of ``extract_slot_state``); ``table_row``, the importing
    engine's freshly allocated physical block ids, when it runs the paged
    path."""
    state.importance[slot] = importance
    state.tier[slot] = tier
    state.last_hot[slot] = last_hot
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
    """Fraction of this step's working set also in the previous one,
    averaged over the batch as XLA's mean is: a sum in row order times
    the fp32 reciprocal of the batch size (the step stats then carry
    the reference's value bit for bit)."""
    inter = torch.sum(last_hot & participate, dim=-1)
    denom = torch.clamp(torch.sum(participate, dim=-1), min=1)
    ratio = inter / denom
    return torch.cumsum(ratio, 0)[-1] * (1.0 / ratio.shape[0])


# ------------------------------------------------------------------ manager
class PAMManager:
    """PAMState transitions bound to one ``PAMManagerConfig``: the
    reference's manager object over the functions above. Each method
    returns a new state and leaves the one it was given as it was."""

    def __init__(self, cfg: PAMManagerConfig):
        self.cfg = cfg

    def participation(self, state: PAMState, lengths: torch.Tensor
                      ) -> torch.Tensor:
        """Step 1: the (B, Smax) tokens read this step."""
        return participation_mask(self.cfg, state.importance, lengths)

    def observe(self, state: PAMState, scores: torch.Tensor,
                lengths: torch.Tensor, participate: torch.Tensor
                ) -> PAMState:
        """Steps 3 and 4: EMA update, hot append, capacity cascade and,
        every ``schedule_interval`` steps, Alg. 2."""
        return observe_update(self.cfg, state, scores, lengths, participate)

    def place_prefill(self, state: PAMState, slot, length) -> PAMState:
        """Recency fill-down placement of one admitted sequence."""
        copy = state._replace(importance=state.importance.clone(),
                              tier=state.tier.clone(),
                              last_hot=state.last_hot.clone(),
                              block_table=state.block_table.clone())
        return place_prefill_state(self.cfg, copy, int(slot), int(length))

    def tier_read_counts(self, state: PAMState, participate: torch.Tensor
                         ) -> torch.Tensor:
        """(3,) tokens read per tier (bytes = counts x token bytes)."""
        return tier_read_counts_of(state.tier, participate)

    def hit_rate(self, state: PAMState, participate: torch.Tensor
                 ) -> torch.Tensor:
        """Context locality: share of this step's working set that the
        previous step also read."""
        return hit_rate_of(state.last_hot, participate)
