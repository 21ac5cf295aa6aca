"""KV-token importance tracking (paper §6.3.1, eqs. 7-8).

Counterpart of ``repro.core.importance``:

    I_i(j) = lam * S_i(j) + (1 - lam) * I_i(j-1)          (eq. 7)
    IS_D(j) = sum_{i in D} I_i(j) / #tokens(D)            (eq. 8)

``S_i(j)`` is the step's attention mass a token received (head-mean,
count-scaled). Selections rank with stable sorts: among equal scores
the lower index comes first, as ``jax.lax.top_k`` and ``jnp.argsort``
order them (``topk_indices``).
"""

from __future__ import annotations

import torch

DEFAULT_LAMBDA = 0.6  # paper: "lambda is set as 0.6"


def update_importance(importance: torch.Tensor, step_score: torch.Tensor,
                      lam: float = DEFAULT_LAMBDA) -> torch.Tensor:
    """Eq. (7): EMA update. Shapes broadcast; typically (B, tokens)."""
    return lam * step_score + (1.0 - lam) * importance


def topk_indices(scores: torch.Tensor, k) -> torch.Tensor:
    """Indices of the ``k`` largest entries of the last axis, largest
    first, ties in index order (``jax.lax.top_k``'s order)."""
    return torch.argsort(scores, dim=-1, descending=True, stable=True
                         )[..., :k]


def step_score_from_attn_weights(weights: torch.Tensor,
                                 head_axis: int = 0) -> torch.Tensor:
    """S_i(j) from attention probabilities (..., heads, tokens): the
    head-mean mass per token times the token count."""
    score = torch.mean(weights, dim=head_axis)
    return score * score.shape[-1]


def tier_importance_score(importance: torch.Tensor,
                          tier_of_token: torch.Tensor, num_tiers: int = 3,
                          valid: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Eq. (8): mean importance of the valid tokens on each tier.

    importance, tier_of_token (ints in [0, num_tiers)), valid:
    (tokens,). Returns (num_tiers,); an empty tier scores 0.
    """
    w = (torch.ones_like(importance) if valid is None
         else valid.to(importance.dtype))
    idx = tier_of_token.long()
    zeros = torch.zeros(num_tiers, dtype=importance.dtype,
                        device=importance.device)
    sums = zeros.index_add(0, idx, importance * w)
    counts = zeros.index_add(0, idx, w)
    return sums / torch.clamp(counts, min=1.0)


def topk_hot_set(importance: torch.Tensor, k: int,
                 valid: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` most important tokens (the hot working set): (indices
    (k,), mask (tokens,) bool). Invalid tokens score -inf, and are
    never marked in the mask."""
    scores = importance
    if valid is not None:
        scores = importance.masked_fill(~valid, float("-inf"))
    idx = topk_indices(scores, k)
    mask = torch.zeros(importance.shape, dtype=torch.bool,
                       device=importance.device)
    mask[idx] = True if valid is None else valid[idx]
    return idx, mask


def context_locality_hit_rate(prev_hot: torch.Tensor,
                              cur_hot: torch.Tensor) -> torch.Tensor:
    """Fraction of the current hot set already hot last step (§3.2)."""
    inter = torch.sum(prev_hot & cur_hot)
    return inter / torch.clamp(torch.sum(cur_hot), min=1)
