"""PAMattention (paper §5, Algorithm 1): one decode step for one
sequence, as plain tensor code.

Counterpart of ``repro.core.pam_attention``:

  1. (optional) retrieval sparsity picks the participating tokens: the
     top-(S_valid / compression) by importance, ties in index order;
  2. tokens are partitioned by tier residency (HBM / DDR / SSD);
  3. each tier's partial ``(O, m, l)`` comes from one shared grouped
     score matrix (H_kv, rep, S), so no KV is repeated per query head;
  4. ``tree_merge`` reduces the tier partials exactly;
  5. the step's attention mass per token feeds the eq. (7) update.

The kernel form of step 3 over batched tier pools is
``kernels.ops.pam_decode_attention``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import importance as imp_mod
from repro_torch.core import online_softmax as osm
from repro_torch.core.tiers import COLD, HOT, WARM


@dataclasses.dataclass(frozen=True)
class PAMAttentionConfig:
    num_tiers: int = 3
    use_sparsity: bool = True
    compression: int = 8          # keep S/compression tokens per step
    lam: float = imp_mod.DEFAULT_LAMBDA


class PAMAttentionOutput(NamedTuple):
    out: torch.Tensor             # (H, d) attention output
    step_scores: torch.Tensor     # (S,) per-token attention mass S_i(j)
    new_importance: torch.Tensor  # (S,) eq. (7) update


def _participation(valid: torch.Tensor, importance: torch.Tensor,
                   compression: int) -> torch.Tensor:
    """The top-k valid tokens by importance, k = max(S_valid //
    compression, 1) (never above the reference's static max(S //
    compression, 1)), in ``jax.lax.top_k`` order."""
    S = valid.shape[0]
    k = min(max(S // compression, 1),
            max(int(valid.sum()) // compression, 1))
    sel = torch.zeros_like(valid)
    sel[imp_mod.topk_indices(importance.masked_fill(~valid, float("-inf")),
                             k)] = True
    return sel & valid


def pam_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       tier_of_token: torch.Tensor, valid: torch.Tensor,
                       importance: torch.Tensor,
                       cfg: PAMAttentionConfig = PAMAttentionConfig(),
                       scale: float | None = None) -> PAMAttentionOutput:
    """One decode-step attention for one sequence (Alg. 1).

    q: (H, d) current query; k, v: (S, H_kv, d) the cached KV (GQA: H a
    multiple of H_kv); tier_of_token / valid / importance: (S,). Scores
    and partials are fp32 whatever the KV dtype; ``out`` is in q's.
    """
    S, H_kv, d = k.shape
    H = q.shape[0]
    rep = H // H_kv
    participate = (_participation(valid, importance, cfg.compression)
                   if cfg.use_sparsity else valid)

    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.float().reshape(H_kv, rep, d)
    s_all = torch.einsum("grd,sgd->grs", qg, k.float()) * sc
    vf = v.float()

    partials = []
    for tier in (HOT, WARM, COLD)[: cfg.num_tiers]:
        mask = participate & (tier_of_token == tier)          # (S,)
        s = s_all.masked_fill(~mask, float("-inf"))
        m = torch.amax(s, dim=-1)                              # (H_kv, rep)
        p = torch.exp(s - osm._safe(m)[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        o = torch.einsum("grs,sgd->grd", p, vf)
        partials.append(osm.AttnPartial(o=o, m=m, l=torch.sum(p, dim=-1)))

    stacked = osm.AttnPartial(*(torch.stack(f) for f in zip(*partials)))
    merged = osm.tree_merge(stacked)
    out = osm.finalize(merged, out_dtype=q.dtype).reshape(H, d)
    step_scores = _attention_mass(s_all, participate, merged)
    new_imp = imp_mod.update_importance(importance, step_scores, lam=cfg.lam)
    return PAMAttentionOutput(out=out, step_scores=step_scores,
                              new_importance=new_imp)


def _attention_mass(s_all: torch.Tensor, participate: torch.Tensor,
                    merged: osm.AttnPartial) -> torch.Tensor:
    """Per-token softmax mass (head-mean, count-scaled) for importance,
    from the shared scores s_all (H_kv, rep, S) and the merged (m, l)
    (H_kv, rep) of the tier merge."""
    H_kv, rep, S = s_all.shape
    s = s_all.masked_fill(~participate, float("-inf"))
    p = (torch.exp(s - osm._safe(merged.m)[..., None])
         / torch.clamp(merged.l, min=1e-30)[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    return imp_mod.step_score_from_attn_weights(p.reshape(H_kv * rep, S),
                                                head_axis=0)
