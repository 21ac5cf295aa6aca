"""Attention entry points around the kernels.

Counterpart of ``repro.kernels.ops``. ``fused_attention`` (train /
prefill) runs ``flash_attention``; ``ssd`` (the Mamba-2 train path) runs
``ssd_scan``. The local stage of every decode
attention partial runs through a merged kernel wrapper of
``repro_torch.kernels.flash_decode`` (the CUDA kernel on the card, which
also merges its splits; its plain version on the CPU). The masked decode
functions take the per-token attention mass from the scores those
kernels return, the values that entered their softmax; the tier merge
(``online_softmax.merge_partials``) and the mass stay plain tensor code.
"""

from __future__ import annotations

import torch

from repro_torch.core import online_softmax as osm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import (flash_decode_merged,
                                              flash_decode_paged_merged,
                                              ring_gather_mask,
                                              ring_position_map)
from repro_torch.kernels.ssd_scan import ssd_scan


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """Prefill/train attention. q: (B, H, S, d), k/v: (B, H_kv, S, d) ->
    (B, H, S, d), differentiable (the backward kernels on the card)."""
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           block_q=block_q, block_k=block_k)


def _stacked(o, m, l) -> osm.AttnPartial:
    return osm.AttnPartial(o=torch.movedim(o, 2, 0), m=torch.movedim(m, 2, 0),
                           l=torch.movedim(l, 2, 0))


def merge_decode(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Reduction stage (Alg. 1 ``Reduction``): merge split partials.

    o: (B, H, nsplit, d); m/l: (B, H, nsplit). Returns (B, H, d).
    """
    return osm.finalize(osm.merge_many(_stacked(o, m, l)),
                        out_dtype=out_dtype)


def decode_attention_partial(q, k, v, mask=None, *, kv_len=None,
                             kv_lens=None, scale=None) -> osm.AttnPartial:
    """Local stage over one dense pool — the merged per-pool partial,
    fields (B, H, d) / (B, H)."""
    return osm.AttnPartial(*flash_decode_merged(
        q, k, v, mask, kv_len=kv_len, kv_lens=kv_lens, scale=scale))


def _grouped_scores(q: torch.Tensor, k: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """One repeat-free grouped QK^T: q (B, H, d), k (B, Hkv, S, d) ->
    (B, Hkv, rep, S) fp32."""
    B, H, d = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, H // Hkv, d)
    return torch.matmul(qg, k.float().transpose(-1, -2)) * scale


def _grouped_partial_from_scores(s: torch.Tensor, v: torch.Tensor,
                                 live: torch.Tensor) -> osm.AttnPartial:
    """Partial (o, m, l) from grouped scores s (B, Hkv, rep, S), v (B,
    Hkv, S, d) and live (B, S); dead rows carry m = -inf."""
    B, Hkv, rep, S = s.shape
    d = v.shape[-1]
    ninf = torch.full_like(s, float("-inf"))
    s = torch.where(live[:, None, None, :], s, ninf)
    m = torch.amax(s, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    o = torch.matmul(p, v.float())
    return osm.AttnPartial(o=o.reshape(B, Hkv * rep, d),
                           m=m.reshape(B, Hkv * rep),
                           l=l.reshape(B, Hkv * rep))


def _probs(s: torch.Tensor, mask: torch.Tensor, m_safe: torch.Tensor,
           inv_l: torch.Tensor) -> torch.Tensor:
    """Normalised probabilities of scores s (B, H, S) under a merged (m,
    l), zero outside ``mask`` (B, S); (B, Hkv, rep, S)."""
    B, Hkv, rep = m_safe.shape
    s = s.reshape(B, Hkv, rep, -1)
    p = torch.exp(s - m_safe[..., None]) * inv_l
    return torch.where(mask[:, None, None, :], p, torch.zeros_like(p))


def _merged_stats(part: osm.AttnPartial, B: int, Hkv: int, rep: int):
    m = part.m.reshape(B, Hkv, rep)
    l = part.l.reshape(B, Hkv, rep)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    inv_l = 1.0 / torch.clamp(l, min=1e-30)[..., None]
    return m_safe, inv_l


def masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            participate: torch.Tensor | None,
                            kv_lens: torch.Tensor, *, scale=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Repeat-free GQA decode attention + per-token attention mass.

    q: (B, H, d); k/v: (B, H_kv, S, d); participate: (B, S) bool or None;
    kv_lens: (B,). Returns (out (B, H, d), mass (B, S)): the local stage
    runs ``flash_decode_merged`` (ragged lengths through ``kv_lens``),
    and the head-mean, count-scaled mass comes from the scores it
    returns under the merged (m, l).
    """
    B, H, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    live = torch.arange(S, device=q.device)[None, :] < kv_lens[:, None]
    if participate is not None:
        live = live & participate
    o, m, l, s = flash_decode_merged(q, k, v, participate, kv_lens=kv_lens,
                                     scale=sc, scores=True)
    part = osm.AttnPartial(o, m, l)
    out = osm.finalize(part, out_dtype=q.dtype)
    m_safe, inv_l = _merged_stats(part, B, Hkv, H // Hkv)
    n_live = torch.sum(live, dim=-1, keepdim=True).float()
    mass = torch.mean(_probs(s, live, m_safe, inv_l), dim=(1, 2)) * n_live
    return out, mass


def paged_decode_attention_partial(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_table: torch.Tensor,
                                   token_mask: torch.Tensor, *,
                                   block_live: torch.Tensor | None = None,
                                   block_offset: int | None = None,
                                   scale=None) -> osm.AttnPartial:
    """Local stage over a paged pool: merged per-pool partial, fields
    (B, H, d) / (B, H). ``block_offset`` makes the pool slices shard-local
    while the table keeps global ids: entries outside the local range
    are masked out of the partial entirely."""
    return osm.AttnPartial(*flash_decode_paged_merged(
        q, k_pool, v_pool, block_table, token_mask, block_live=block_live,
        block_offset=block_offset, scale=scale))


def paged_masked_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor,
                                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                                  block_table: torch.Tensor,
                                  hot_mask: torch.Tensor,
                                  paged_mask: torch.Tensor,
                                  kv_lens: torch.Tensor, *,
                                  block_live: torch.Tensor | None = None,
                                  scale=None
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiered decode attention: hot-ring partial ⊕ paged warm/cold partial.

    The hot tier reads the ring buffer (``k_cache``/``v_cache``, (B, Hkv,
    W, dh), absolute position p at slot ``p % W``) through
    ``flash_decode_merged`` with the hot mask pulled onto ring
    coordinates and ``kv_len=W``; the warm/cold tiers read the block pool
    through ``flash_decode_paged_merged``. The two partials merge exactly
    (Alg. 1).

    Returns (out (B, H, d), mass (B, Smax)): ``mass`` is the head-mean,
    count-scaled softmax mass over the union working set in absolute
    coordinates, from the scores both kernels return under the merged
    (m, l), the hot part scattered back through the ring index map.
    """
    B, H, d = q.shape
    Hkv, W = k_cache.shape[1], k_cache.shape[2]
    Smax = hot_mask.shape[1]
    sc = scale if scale is not None else 1.0 / (d ** 0.5)
    live_len = torch.arange(Smax, device=q.device)[None, :] < kv_lens[:, None]
    hot = hot_mask & live_len
    pgd = paged_mask & live_len

    ring_pos, ring_valid = ring_position_map(kv_lens, W)
    hot_ring = ring_gather_mask(hot, ring_pos, ring_valid)
    *part_hot, s_ring = flash_decode_merged(q, k_cache, v_cache, hot_ring,
                                            kv_len=W, scale=sc, scores=True)
    *part_paged, s_pool = flash_decode_paged_merged(
        q, k_pool, v_pool, block_table, pgd, block_live=block_live,
        scale=sc, scores=True)
    merged = osm.merge_partials(osm.AttnPartial(*part_hot),
                                osm.AttnPartial(*part_paged))
    out = osm.finalize(merged, out_dtype=q.dtype)

    # union mass in absolute coordinates from the merged (m, l)
    m_safe, inv_l = _merged_stats(merged, B, Hkv, H // Hkv)
    ph = torch.mean(_probs(s_ring, hot_ring, m_safe, inv_l), dim=(1, 2))
    pp = torch.mean(_probs(s_pool, pgd, m_safe, inv_l), dim=(1, 2))
    idx = ring_pos.clamp(0, Smax - 1)
    mass = pp.scatter_add(1, idx, torch.where(hot_ring, ph,
                                              torch.zeros_like(ph)))
    hot_eff = torch.zeros((B, Smax), dtype=torch.int32, device=q.device)
    hot_eff = hot_eff.scatter_reduce(1, idx, hot_ring.to(torch.int32),
                                     reduce="amax").bool()
    n_live = torch.sum(hot_eff | pgd, dim=-1, keepdim=True).float()
    return out, mass * n_live


def ssd(x, dt, a, b, c, d_skip, *, chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD chunked scan, differentiable (the backward kernels on
    the card). See ``ssd_scan`` for shapes."""
    return ssd_scan(x, dt, a, b, c, d_skip, chunk=chunk)
