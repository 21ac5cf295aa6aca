"""Retrieval-based KV sparsity (paper §2.3.1 / §7.1).

Counterpart of ``repro.core.sparsity``. The paper runs every system with
Double Sparsity at 8x compression: the whole KV set stays cached, but
each decode step loads only the top-(S/8) most relevant tokens.
Relevance is estimated from a few "label" channels (the largest-|K|
channels, chosen offline), so the scoring pass reads r << d channels a
token. Selections keep ``jax.lax.top_k``'s order (ties: lower index
first); recency pins make many ties at ``+inf``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.importance import topk_indices


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    compression: int = 8          # paper: 8x
    label_channels: int = 16      # r channels used for approximate scoring
    recency_window: int = 32      # always keep the most recent tokens


def choose_label_channels(k_sample: torch.Tensor, r: int) -> torch.Tensor:
    """Offline channel selection: the ``r`` channels of largest mean |K|
    over calibration keys ``k_sample`` (S, d). Returns (r,) channel ids,
    largest first."""
    mag = torch.mean(torch.abs(k_sample.float()), dim=0)
    return topk_indices(mag, r)


def approx_scores(q: torch.Tensor, k_label: torch.Tensor,
                  label_idx: torch.Tensor) -> torch.Tensor:
    """Approximate attention logits from the label channels only.

    q: (H, d); k_label: (S, r) label-channel cache; label_idx: (r,).
    Returns (S,), the head-mean logit estimate.
    """
    ql = q[..., label_idx.long()].float()                 # (H, r)
    s = torch.einsum("hr,sr->hs", ql, k_label.float())
    s = s / math.sqrt(q.shape[-1])
    return torch.mean(s, dim=0)


def select_topk(scores: torch.Tensor, valid: torch.Tensor, k: int,
                num_tokens=None, recency_window: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` tokens to load this step: (indices (k,), mask (S,)
    bool). Valid tokens within ``recency_window`` of ``num_tokens`` (the
    sequence tail) are pinned (score ``+inf``); invalid ones score
    ``-inf`` and are never in the mask."""
    s = scores.masked_fill(~valid, float("-inf"))
    if recency_window and num_tokens is not None:
        pos = torch.arange(s.shape[0], device=s.device)
        recent = (pos >= num_tokens - recency_window) & valid
        s = s.masked_fill(recent, float("inf"))
    idx = topk_indices(s, k)
    mask = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    mask[idx] = True
    return idx, mask & valid


def sparse_step_scores(weights_mean: torch.Tensor, selected: torch.Tensor
                       ) -> torch.Tensor:
    """S_i(j) for eq. (7): the attention mass of selected tokens, 0 for
    the others (they were not loaded, so they contributed nothing)."""
    return torch.where(selected, weights_mean,
                       torch.zeros_like(weights_mean))
