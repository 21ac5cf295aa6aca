"""Inter-device online KV scheduling (paper §6.3.2, Algorithm 2).

Counterpart of ``repro.core.scheduling``. Greedy swap loop driving the
per-tier importance ratio ``IS_H : IS_D : IS_S`` toward ``x : y : 1``:

  phase 1: while (x* + y*) < (x + y):  swap(least-important DDR token,
                                             most-important SSD token)
  phase 2: while x*/y*   <   x/y:      swap(least-important HBM token,
                                             most-important DDR token)

The reference runs each phase as a ``lax.while_loop`` under ``vmap``.
Here each phase is ``max_swaps`` masked iterations vectorised over the
batch: a row whose loop condition fails or that found no improving swap
("stuck") is frozen for the rest of the phase, so no iteration needs the
host to look at device values. The swap budget is shared by the two
phases, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tiers import COLD, HOT, WARM


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    x: float = 8.0            # target IS_H / IS_S   (offline-profiled)
    y: float = 3.0            # target IS_D / IS_S
    max_swaps: int = 32       # per decode step; paper: ~0.7% of tokens
    eps: float = 1e-6


def _tier_mean(imp, tier, valid, t):
    on = (tier == t) & valid
    cnt = torch.clamp(on.sum(dim=-1), min=1)
    return torch.where(on, imp, torch.zeros_like(imp)).sum(dim=-1) / cnt


def _ratios(imp, tier, valid, cfg):
    is_h = _tier_mean(imp, tier, valid, HOT)
    is_d = _tier_mean(imp, tier, valid, WARM)
    is_s = torch.clamp(_tier_mean(imp, tier, valid, COLD), min=cfg.eps)
    return is_h / is_s, is_d / is_s


def _swap_phase(imp, valid, tier, swaps, moved, src_tier, dst_tier,
                cond_fn, max_swaps):
    """Repeatedly swap (least-important src) <-> (most-important dst),
    per row, while that row's condition holds and swaps remain."""
    B = imp.shape[0]
    rows = torch.arange(B, device=imp.device)
    pos_inf = torch.full_like(imp, float("inf"))
    neg_inf = torch.full_like(imp, float("-inf"))
    done = torch.zeros(B, dtype=torch.bool, device=imp.device)
    for _ in range(max_swaps):
        done = done | (swaps >= max_swaps) | ~cond_fn(tier)
        on_src = (tier == src_tier) & valid
        on_dst = (tier == dst_tier) & valid
        demote = torch.argmin(torch.where(on_src, imp, pos_inf), dim=-1)
        promote = torch.argmax(torch.where(on_dst, imp, neg_inf), dim=-1)
        ok = (on_src.any(dim=-1) & on_dst.any(dim=-1)
              & (imp[rows, promote] > imp[rows, demote]))
        go = ok & ~done
        done = done | ~ok                      # stuck: no improving swap
        d_val = torch.where(go, torch.full_like(demote, dst_tier),
                            tier[rows, demote].long())
        tier[rows, demote] = d_val.to(tier.dtype)
        p_val = torch.where(go, torch.full_like(promote, src_tier),
                            tier[rows, promote].long())
        tier[rows, promote] = p_val.to(tier.dtype)
        moved[rows, demote] = moved[rows, demote] | go
        moved[rows, promote] = moved[rows, promote] | go
        swaps = swaps + go.to(swaps.dtype)
    return tier, swaps, moved


def schedule_kv(importance: torch.Tensor, tier_of_token: torch.Tensor,
                valid: torch.Tensor, cfg: ScheduleConfig = ScheduleConfig()
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run Algorithm 2 on every row of (B, tokens) inputs. Returns
    (new_tier_of_token (B, tokens), moved_mask (B, tokens), num_swaps
    (B,))."""
    imp = importance.float()
    B = imp.shape[0]
    tier = tier_of_token.clone()              # updated in place below
    swaps = torch.zeros(B, dtype=torch.int32, device=imp.device)
    moved = torch.zeros_like(valid)

    def phase1_cond(t):
        xs, ys = _ratios(imp, t, valid, cfg)
        return (xs + ys) < (cfg.x + cfg.y)

    def phase2_cond(t):
        xs, ys = _ratios(imp, t, valid, cfg)
        return xs < (cfg.x / cfg.y) * torch.clamp(ys, min=cfg.eps)

    tier, swaps, moved = _swap_phase(imp, valid, tier, swaps, moved, WARM,
                                     COLD, phase1_cond, cfg.max_swaps)
    tier, swaps, moved = _swap_phase(imp, valid, tier, swaps, moved, HOT,
                                     WARM, phase2_cond, cfg.max_swaps)
    return tier, moved, swaps


def ratio_error(importance: torch.Tensor, tier_of_token: torch.Tensor,
                valid: torch.Tensor, cfg: ScheduleConfig) -> torch.Tensor:
    """Distance of the tier-importance ratios from the ``x : y : 1``
    target, the quantity Algorithm 2 never increases. Inputs (tokens,)
    or (B, tokens); returns () or (B,)."""
    xs, ys = _ratios(importance.float(), tier_of_token, valid, cfg)
    return (torch.clamp(cfg.x + cfg.y - (xs + ys), min=0.0)
            + torch.clamp(cfg.x / cfg.y - xs / torch.clamp(ys, min=cfg.eps),
                          min=0.0))
