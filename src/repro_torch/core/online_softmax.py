"""Online-softmax partial-attention algebra (PAMattention §5.1, Alg. 1).

Counterpart of ``repro.core.online_softmax``: the algebra behind Alg. 1
(``local_attention`` per partition, ``merge_partials`` / ``merge_many``
/ ``tree_merge`` to reduce, ``finalize``) and the monolithic oracle it
must equal (``reference_attention``). A partition of the KV set carries
``(O, m, l)``:

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

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device


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


def empty_partial(d: int, batch_shape: tuple[int, ...] = (),
                  dtype: torch.dtype = torch.float32,
                  device: str | torch.device | None = None) -> AttnPartial:
    """The merge identity: ``o = 0``, ``m = -inf``, ``l = 0``. Made on
    ``device`` (CUDA unless the caller names another)."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    return AttnPartial(o=torch.zeros(batch_shape + (d,), **kw),
                       m=torch.full(batch_shape, float("-inf"), **kw),
                       l=torch.zeros(batch_shape, **kw))


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float | None,
            mask: torch.Tensor | None) -> torch.Tensor:
    """fp32 scaled logits (..., S) of q (..., d) against k (..., S, d),
    ``-inf`` where ``mask`` is False."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("...d,...sd->...s", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    return s


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None,
                    mask: torch.Tensor | None = None) -> AttnPartial:
    """Alg. 1 ``Local_Attention``: partial attention over one partition.

    q: (..., d), k/v: (..., S, d); ``mask``: optional bool (..., S),
    False positions excluded. fp32 math whatever the input dtype; a fully
    masked partition gives ``m = -inf``, ``o = l = 0``.
    """
    s = _scores(q, k, scale, mask)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - _safe(m)[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    o = torch.einsum("...s,...sd->...d", p, v.float())
    return AttnPartial(o=o, m=m, l=l)


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


def tree_merge(partials: AttnPartial) -> AttnPartial:
    """Hierarchical (binary-tree) reduction of a stacked partial (leading
    axis = partitions), pairing halves ``[:t//2]`` / ``[t//2:]`` as the
    reference does, so the fp32 sums run in its order."""
    t = partials.o.shape[0]
    if t == 1:
        return AttnPartial(partials.o[0], partials.m[0], partials.l[0])
    half = t // 2
    left = tree_merge(AttnPartial(partials.o[:half], partials.m[:half],
                                  partials.l[:half]))
    right = tree_merge(AttnPartial(partials.o[half:], partials.m[half:],
                                   partials.l[half:]))
    return merge_partials(left, right)


def finalize(p: AttnPartial, out_dtype: torch.dtype | None = None
             ) -> torch.Tensor:
    """Normalize a merged partial into the attention output O / l."""
    l_safe = torch.where(p.l > 0, p.l, torch.ones_like(p.l))
    out = p.o / l_safe[..., None]
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def attention_from_partitions(q: torch.Tensor, ks: list[torch.Tensor],
                              vs: list[torch.Tensor],
                              scale: float | None = None,
                              masks: list[torch.Tensor | None] | None = None,
                              out_dtype: torch.dtype | None = None
                              ) -> torch.Tensor:
    """End-to-end Alg. 1: ``local_attention`` per partition, merged left
    to right, finalized in ``out_dtype`` (default q's)."""
    if masks is None:
        masks = [None] * len(ks)
    acc = None
    for k, v, msk in zip(ks, vs, masks):
        part = local_attention(q, k, v, scale=scale, mask=msk)
        acc = part if acc is None else merge_partials(acc, part)
    if acc is None:
        raise ValueError("attention_from_partitions needs a partition")
    return finalize(acc, out_dtype=out_dtype or q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None,
                        mask: torch.Tensor | None = None,
                        out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """Monolithic softmax attention: the oracle Alg. 1 must equal."""
    p = torch.softmax(_scores(q, k, scale, mask), dim=-1)
    out = torch.einsum("...s,...sd->...d", p, v.float())
    return out.to(out_dtype or q.dtype)
