"""Online-softmax partial-attention algebra (PAMattention §5.1, Alg. 1).

Counterpart of ``repro.core.online_softmax``. A partition of the KV set
carries ``(O, m, l)``:

    O_t = sum_j exp(s_j - m_t) v_j     (unnormalized partial output)
    m_t = max_j s_j                    (partition max logit)
    l_t = sum_j exp(s_j - m_t)         (partition normalizer at m_t)

and partitions merge exactly in any order:

    m* = max_t m_t,  O = sum_t exp(m_t - m*) O_t,  l = sum_t exp(m_t - m*) l_t

Dead partitions may carry ``m = -inf`` (the grouped plain path) or the
kernels' finite sentinel ``m = -1e30``; both merge to the same result,
because a sentinel's weight ``exp(-1e30 - m*)`` underflows to 0 against
any live partition and an all-dead merge keeps ``o = l = 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AttnPartial(NamedTuple):
    """Partial attention state for one KV partition.

      o: (..., d)   unnormalized output  sum exp(s - m) * v
      m: (...,)     running max logit
      l: (...,)     running normalizer  sum exp(s - m)
    """

    o: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor


def _safe(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def merge_partials(a: AttnPartial, b: AttnPartial) -> AttnPartial:
    """Alg. 1 ``Reduction`` for two partials — associative & commutative."""
    m = torch.maximum(a.m, b.m)
    m_safe = _safe(m)
    zero = torch.zeros_like(m)
    wa = torch.where(torch.isfinite(a.m), torch.exp(a.m - m_safe), zero)
    wb = torch.where(torch.isfinite(b.m), torch.exp(b.m - m_safe), zero)
    return AttnPartial(o=wa[..., None] * a.o + wb[..., None] * b.o, m=m,
                       l=wa * a.l + wb * b.l)


def merge_many(partials: AttnPartial) -> AttnPartial:
    """Reduce a stacked AttnPartial whose leading axis indexes partitions.

    o: (T, ..., d), m/l: (T, ...). Single-pass exact merge.
    """
    m_star = torch.amax(partials.m, dim=0)
    m_safe = _safe(m_star)
    w = torch.where(torch.isfinite(partials.m),
                    torch.exp(partials.m - m_safe[None]),
                    torch.zeros_like(partials.m))
    o = torch.sum(w[..., None] * partials.o, dim=0)
    l = torch.sum(w * partials.l, dim=0)
    return AttnPartial(o=o, m=m_star, l=l)


def finalize(p: AttnPartial, out_dtype: torch.dtype | None = None
             ) -> torch.Tensor:
    """Normalize a merged partial into the attention output O / l."""
    l_safe = torch.where(p.l > 0, p.l, torch.ones_like(p.l))
    out = p.o / l_safe[..., None]
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out
