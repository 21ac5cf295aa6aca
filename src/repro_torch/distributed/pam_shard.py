"""Distributed PAMattention (paper Alg. 1 across sites) on one
controller.

Counterpart of ``repro.distributed.pam_shard``. The KV is
sequence-sharded over a sharded engine's sites, each site playing one
PIM site that holds a KV partition. One decode step:

  local stage : each site attends its own KV slice -> (O, m, l)
  merge stage : the exact online-softmax reduction across the sites,
                m* = max_r m_r;  O = sum_r e^{m_r - m*} O_r;
                l = sum_r e^{m_r - m*} l_r

The merge moves H x (d + 2) floats a site whatever the context length
(``merge_collective_bytes``); a gather-based scheme would move the whole
KV slice (``make_gather_based_decode_attn``). ``fused_update_decode``
(the ``pam_shard_decode`` perf flag) also writes the new token into the
site that owns its position, over the ambient grid's sites.

One Python controller drives every site, as the reference's one program
drives its mesh: a site's local stage runs on its own slice of the
engine's tensors, and every cross-site reduction goes through
``site_all_reduce`` (max, then sums in site order). ``decode_sites``
places every site on one device; an engine whose sites sit on distinct
cards swaps ``site_all_reduce`` for NCCL's all-reduce.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.core import online_softmax as osm
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DecodeSites:
    """The sites of a sharded engine, in site order, each with its
    device."""
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def decode_sites(shard: int, device: str | torch.device | None = None
                 ) -> DecodeSites:
    """The engine's ``shard`` sites, the counterpart of the reference's
    ``decode_mesh``: every site on ``device`` (CUDA unless the caller
    names another), as the reference's sites are host devices of one
    CPU in its tests. A site holds its slice of the weights, the ring
    and the pool as views of the engine's tensors on that device."""
    if shard < 1:
        raise ValueError(f"shard must be >= 1, got {shard}")
    return DecodeSites(devices=(resolve_device(device),) * shard)


def merge_collective_bytes(n_layers: int, n_heads: int, head_dim: int,
                           batch: int, *, smax: int = 0
                           ) -> tuple[int, int]:
    """Modeled collective bytes a site of ONE sharded decode step.

    Returns ``(merge_bytes, mass_bytes)``: ``merge_bytes`` is the Alg. 1
    cross-site reduction of the ``(O, m, l)`` triple, ``H x (d + 2)``
    fp32 a layer and a batch row, independent of context length (the
    paper's flat-communication claim); ``mass_bytes`` is the
    importance-mass sum that keeps the EMA / Alg. 2 state replicated,
    linear in ``smax``, reported apart."""
    merge = n_layers * batch * n_heads * (head_dim + 2) * 4
    mass = n_layers * batch * smax * 4
    return merge, mass


def site_all_reduce(xs: Sequence[torch.Tensor], op: str = "sum"
                    ) -> torch.Tensor:
    """The cross-site reduction: the sites' values ``xs`` (site order)
    reduced elementwise by ``op`` (``"max"`` or ``"sum"``, the sums in
    site order), the value every site reads afterwards. Every reduction
    across sites (the attention merge, the mass, the row-parallel
    products' partial sums) goes through here."""
    if op not in ("sum", "max"):
        raise ValueError(f"site_all_reduce: op must be 'sum' or 'max', "
                         f"got {op!r}")
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, x) if op == "max" else acc + x
    return acc


def site_all_gather(xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The sites' slices ``xs`` joined along ``dim`` in site order (an
    all-gather: every site reads the whole)."""
    return torch.cat(list(xs), dim=dim)


def _merge_across_sites(parts: Sequence[osm.AttnPartial]):
    """Alg. 1's reduction over the sites' merged partials: (o, l, m*
    with non-finite entries at 0). Dead partials carry the kernels'
    finite sentinel or -inf; both weigh 0 against a live one."""
    m_star = site_all_reduce([p.m for p in parts], "max")
    m_star_safe = torch.where(torch.isfinite(m_star), m_star,
                              torch.zeros_like(m_star))
    ws = [torch.where(torch.isfinite(p.m), torch.exp(p.m - m_star_safe),
                      torch.zeros_like(p.m)) for p in parts]
    o = site_all_reduce([w[..., None] * p.o for w, p in zip(ws, parts)])
    l = site_all_reduce([w * p.l for w, p in zip(ws, parts)])
    return o, l, m_star_safe


def make_sharded_paged_decode_attn(sites: DecodeSites,
                                   hot_mask: torch.Tensor,
                                   paged_mask: torch.Tensor,
                                   block_table: torch.Tensor,
                                   block_live: torch.Tensor, *,
                                   scale: float | None = None):
    """The sharded engine's attention: hot-ring ⊕ paged partials with the
    ring's slot axis and the pool's block axis split over the sites.

    Twin of ``pam_manager.make_paged_decode_attn``: returns ``d_fn(q,
    kc, vc, pk, pv, kv_lens) -> (out, mass)`` for
    ``transformer.decode_step``, over one layer's ring ``(B, Hkv, W,
    dh)`` and pool ``(NB+1, bs, Hkv, dh)``. Site ``r``, in site order:

      * owns ring slots ``[r W_loc, (r + 1) W_loc)``: its slice of the
        rotated position map (``ring_position_map(start=, size=)``)
        pulls the hot mask onto them, and ``flash_decode_merged`` attends
        the ring's view of those slots with their scores; an in-window
        position lives in exactly one slot, so the hot contributions
        partition across the sites;
      * owns physical blocks ``[r NB_loc, (r + 1) NB_loc)``:
        ``flash_decode_paged_merged`` walks the global block table over
        the pool's view of those blocks with ``block_offset``, entries
        it does not own dead;
      * merges its two partials (``online_softmax.merge_partials``).

    The sites' partials then merge exactly through ``site_all_reduce``
    (Alg. 1 across sites), and the mass is summed onto absolute
    coordinates under the global ``(m*, l)``, from the kernels' scores
    (only a site's own blocks count); the live count comes from the
    max-merged hot mask. ``out`` and ``mass`` are every site's, so the
    importance EMA, Alg. 2 and sampling downstream run as unsharded.
    """
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_decode import (flash_decode_merged,
                                                  flash_decode_paged_merged,
                                                  ring_gather_mask,
                                                  ring_position_map)
    g = sites.size

    def d_fn(q, k_cache, v_cache, pk, pv, kv_lens):
        B, H, d = q.shape
        Hkv, W = k_cache.shape[1], k_cache.shape[2]
        W_loc, NB_loc, bs = W // g, pk.shape[0] // g, pk.shape[1]
        Smax = hot_mask.shape[1]
        rep = H // Hkv
        sc = scale if scale is not None else 1.0 / (d ** 0.5)
        live_len = (torch.arange(Smax, device=q.device)[None, :]
                    < kv_lens[:, None])
        hot = hot_mask & live_len
        pgd = paged_mask & live_len
        local = []
        for r in range(g):
            ring = slice(r * W_loc, (r + 1) * W_loc)
            lo = r * NB_loc
            ring_pos, ring_valid = ring_position_map(
                kv_lens, W, start=r * W_loc, size=W_loc)
            hot_ring = ring_gather_mask(hot, ring_pos, ring_valid)
            *part_hot, s_ring = flash_decode_merged(
                q, k_cache[:, :, ring], v_cache[:, :, ring], hot_ring,
                kv_len=W_loc, scale=sc, scores=True)
            *part_paged, s_pool = flash_decode_paged_merged(
                q, pk[lo:lo + NB_loc], pv[lo:lo + NB_loc], block_table,
                pgd, block_live=block_live, block_offset=lo, scale=sc,
                scores=True)
            merged = osm.merge_partials(osm.AttnPartial(*part_hot),
                                        osm.AttnPartial(*part_paged))
            local.append((merged, ring_pos, hot_ring, s_ring, s_pool, lo))

        # ---- cross-site reduction (Alg. 1 across sites) ---------------
        o, l, m_star = _merge_across_sites([x[0] for x in local])
        inv_l = 1.0 / torch.clamp(l, min=1e-30)
        out = (o * inv_l[..., None]).to(q.dtype)

        # ---- union mass on absolute coordinates, global (m*, l) -------
        mg = m_star.reshape(B, Hkv, rep)
        il = inv_l.reshape(B, Hkv, rep)[..., None]
        masses, hots = [], []
        for _, ring_pos, hot_ring, s_ring, s_pool, lo in local:
            inside = (block_table >= lo) & (block_table < lo + NB_loc)
            pgd_loc = pgd & torch.repeat_interleave(inside, bs, dim=1)
            ph = torch.mean(kops._probs(s_ring, hot_ring, mg, il),
                            dim=(1, 2))                     # (B, W_loc)
            pp = torch.mean(kops._probs(s_pool, pgd_loc, mg, il),
                            dim=(1, 2))                     # (B, Smax)
            idx = ring_pos.clamp(0, Smax - 1)
            masses.append(pp.scatter_add(
                1, idx, torch.where(hot_ring, ph, torch.zeros_like(ph))))
            hots.append(torch.zeros((B, Smax), dtype=torch.int32,
                                    device=q.device).scatter_reduce(
                1, idx, hot_ring.to(torch.int32), reduce="amax"))
        mass = site_all_reduce(masses)
        hot_eff = site_all_reduce(hots, "max").bool()
        n_live = torch.sum(hot_eff | pgd, dim=-1, keepdim=True).float()
        return out, mass * n_live

    return d_fn


def _site_ranges(S: int, g: int) -> list[slice]:
    if S % g:
        raise ValueError(f"{S} positions do not split over {g} sites")
    n = S // g
    return [slice(r * n, (r + 1) * n) for r in range(g)]


def make_sequence_sharded_decode_attn(sites: DecodeSites):
    """A decode attention ``(q, k_cache, v_cache, kv_lens) -> (out,
    mass)`` with the dense cache (B, Hkv, S, dh) sequence-split over the
    sites: each site's grouped partial over its positions (plain tensor
    code, as the reference's ``jnp``), the exact merge through
    ``site_all_reduce``, and the mass (B, S) of each site's positions
    under the global ``(m*, l)``, joined in site order."""
    g = sites.size

    def d_fn(q, k, v, kv_lens):
        B, H, dh = q.shape
        Hkv, S = k.shape[1], k.shape[2]
        rep = H // Hkv
        scale = 1.0 / math.sqrt(dh)
        qg = q.float().reshape(B, Hkv, rep, dh)
        local = []
        for sl in _site_ranges(S, g):
            pos = torch.arange(sl.start, sl.stop, device=q.device)
            live = pos[None, :] < kv_lens[:, None]           # (B, S_loc)
            s = torch.matmul(qg, k[:, :, sl].float().transpose(-1, -2))
            s = (s * scale).masked_fill(~live[:, None, None, :],
                                        float("-inf"))
            m = torch.amax(s, dim=-1)                        # (B, Hkv, rep)
            m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(live[:, None, None, :], p, torch.zeros_like(p))
            local.append((osm.AttnPartial(
                torch.matmul(p, v[:, :, sl].float()), m,
                torch.sum(p, dim=-1)), p, live))
        m_star = site_all_reduce([x[0].m for x in local], "max")
        m_star_safe = torch.where(torch.isfinite(m_star), m_star,
                                  torch.zeros_like(m_star))
        ws = [torch.where(torch.isfinite(x[0].m),
                          torch.exp(x[0].m - m_star_safe),
                          torch.zeros_like(x[0].m)) for x in local]
        o = site_all_reduce([w[..., None] * x[0].o
                             for w, x in zip(ws, local)])
        l = site_all_reduce([w * x[0].l for w, x in zip(ws, local)])
        l_safe = torch.where(l > 0, l, torch.ones_like(l))
        out = (o / l_safe[..., None]).reshape(B, H, dh).to(q.dtype)
        n_live = site_all_reduce([torch.sum(x[2], dim=-1) for x in local])
        masses = [torch.mean(x[1] * w[..., None] / l_safe[..., None],
                             dim=(1, 2)) * n_live[:, None].float()
                  for w, x in zip(ws, local)]
        return out, site_all_gather(masses, dim=1)

    return d_fn


def fused_update_decode(q, k_cache, v_cache, k_new, v_new, kv_lens, *,
                        axis: str = "model"):
    """The ``pam_shard_decode`` perf flag: the new token's cache write
    and PAMattention over the sequence-sharded cache in one pass over
    the ambient grid's ``axis`` sites (``perf_flags.abstract_mesh``; one
    site without a grid).

    Site ``r`` owns positions ``[r S / g, (r + 1) S / g)`` of the caches
    (B, Hkv, S, dh). It writes the new token into its view in place only
    for the rows whose ``kv_lens`` (pre-append lengths) falls in its
    range, a masked local write that keeps the old value elsewhere, as
    the reference does; then its grouped partial over its live positions
    (plain tensor code, fp32 products); then the exact merge through
    ``site_all_reduce`` and each site's mass under the global ``(m*,
    l)``, joined in site order. The batch rows are every data replica's
    at once: a data split changes no number. q: (B, H, dh); k_new /
    v_new: (B, Hkv, dh). Returns (out, mass (B, S), k_cache, v_cache)."""
    from repro_torch.models import perf_flags
    g = perf_flags.abstract_mesh().shape.get(axis, 1)
    B, H, dh = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    bidx = torch.arange(B, device=q.device)
    qg = q.float().reshape(B, Hkv, rep, dh)
    local = []
    for sl in _site_ranges(S, g):
        n = sl.stop - sl.start
        kc, vc = k_cache[:, :, sl], v_cache[:, :, sl]
        pos_local = kv_lens.long() - sl.start
        in_range = ((pos_local >= 0) & (pos_local < n))[:, None, None]
        safe = pos_local.clamp(0, n - 1)
        kc[bidx, :, safe] = torch.where(in_range, k_new, kc[bidx, :, safe])
        vc[bidx, :, safe] = torch.where(in_range, v_new, vc[bidx, :, safe])
        pos = torch.arange(sl.start, sl.stop, device=q.device)
        live = pos[None, :] < (kv_lens + 1)[:, None]         # (B, n)
        s = torch.matmul(qg, kc.float().transpose(-1, -2)) * scale
        s = s.masked_fill(~live[:, None, None, :], float("-inf"))
        m = torch.amax(s, dim=-1)                            # (B, Hkv, rep)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(live[:, None, None, :], p, torch.zeros_like(p))
        local.append((osm.AttnPartial(torch.matmul(p, vc.float()), m,
                                      torch.sum(p, dim=-1)), p, live))
    m_star = site_all_reduce([x[0].m for x in local], "max")
    m_star_safe = torch.where(torch.isfinite(m_star), m_star,
                              torch.zeros_like(m_star))
    ws = [torch.where(torch.isfinite(x[0].m), torch.exp(x[0].m - m_star_safe),
                      torch.zeros_like(x[0].m)) for x in local]
    o = site_all_reduce([w[..., None] * x[0].o for w, x in zip(ws, local)])
    l = site_all_reduce([w * x[0].l for w, x in zip(ws, local)])
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (o / l_safe[..., None]).reshape(B, H, dh).to(q.dtype)
    n_live = site_all_reduce([torch.sum(x[2], dim=-1) for x in local])
    masses = [torch.mean(x[1] * w[..., None] / l_safe[..., None],
                         dim=(1, 2)) * n_live[:, None].float()
              for w, x in zip(ws, local)]
    return out, site_all_gather(masses, dim=1), k_cache, v_cache


def make_gather_based_decode_attn(sites: DecodeSites):
    """The request-level baseline (paper §3.3.1 C1): every site gathers
    the whole KV (``site_all_gather`` of the sites' sequence slices),
    then attends alone. The same numbers as the dense attention, with
    O(S) bytes moved: the ablation counterpart of the sharded merge."""
    g = sites.size

    def d_fn(q, k, v, kv_lens):
        from repro_torch.models.attention import dense_decode_attn
        ranges = _site_ranges(k.shape[2], g)
        k_full = site_all_gather([k[:, :, sl] for sl in ranges], dim=2)
        v_full = site_all_gather([v[:, :, sl] for sl in ranges], dim=2)
        return dense_decode_attn(q, k_full, v_full, kv_lens)

    return d_fn
