"""GQA attention (train, prefill, decode) with optional qk-norm and RoPE.

Counterpart of ``repro.models.attention``. ``attention_train`` runs the
``flash_attention`` kernels (``use_kernel=True``) or q-chunked attention
in plain tensor code, which stays differentiable. Prefill runs q-chunked
attention in plain tensor code, as the reference's serving prefill
does, and so does the suffix prefill over a cached prefix
(``attention_prefill_with_prefix``). Decode attention is injectable
through ``decode_attn_fn`` (the PAM manager's tiered attention in the
engine); the default is dense grouped attention. Decode appends write
the caches in place: the ring slot ``pos % W`` of the dense buffer
and, in paged mode, the token's (block, slot) in the pool. The perf
flags (``models.perf_flags``) ``bf16_probs``, ``sp_attn`` and
``pam_shard_decode`` are read here, as in the reference.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.pam_shard import (site_all_gather,
                                               site_all_reduce)
from repro_torch.kernels import ops as kops
from repro_torch.models import perf_flags
from repro_torch.models.layers import apply_rope, linear, rms_norm

DecodeAttnFn = Callable[..., tuple]


class AttnParams(NamedTuple):
    wq: torch.Tensor                 # (d, H*dh)
    wk: torch.Tensor                 # (d, Hkv*dh)
    wv: torch.Tensor                 # (d, Hkv*dh)
    wo: torch.Tensor                 # (H*dh, d)
    q_norm: Optional[torch.Tensor]   # (dh,) or None
    k_norm: Optional[torch.Tensor]


def _project_qkv(p: AttnParams, x: torch.Tensor, positions: torch.Tensor,
                 n_heads: int, n_kv: int, d_head: int, rope_theta: float,
                 rms_eps: float):
    B, S, _ = x.shape
    q = linear(x, p.wq).reshape(B, S, n_heads, d_head)
    k = linear(x, p.wk).reshape(B, S, n_kv, d_head)
    v = linear(x, p.wv).reshape(B, S, n_kv, d_head)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, rms_eps)
        k = rms_norm(k, p.k_norm, rms_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, chunk: int = 512,
                      scale: float | None = None) -> torch.Tensor:
    """q: (B, S, H, dk); k: (B, S, Hkv, dk); v: (B, S, Hkv, dv).
    fp32 softmax, q-chunked (peak intermediate (B, H, chunk, S)). With
    ``bf16_probs`` the PV product takes bf16 probabilities and values
    (the max and sum stay fp32)."""
    B, S, H, dh = q.shape
    Hkv, dv = k.shape[2], v.shape[-1]
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    kh = torch.movedim(k, 2, 1).float()                  # (B, Hkv, S, dh)
    vh = torch.movedim(v, 2, 1).float()
    qh = torch.movedim(q, 2, 1).reshape(B, Hkv, rep, S, dh)
    kpos = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, S, min(chunk, S)):
        qc = qh[:, :, :, c0:c0 + chunk].float()          # (B,Hkv,rep,c,dh)
        s = torch.matmul(qc, kh[:, :, None].transpose(-1, -2)) * scale
        if causal:
            qpos = c0 + torch.arange(qc.shape[3], device=q.device)
            mask = kpos[None, :] <= qpos[:, None]        # (c, S)
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = torch.nan_to_num(p, nan=0.0)
        if perf_flags.enabled("bf16_probs"):
            outs.append(torch.matmul(p.bfloat16(), vh[:, :, None].bfloat16())
                        .to(q.dtype))
        else:
            outs.append(torch.matmul(p, vh[:, :, None]).to(q.dtype))
    out = torch.cat(outs, dim=3).reshape(B, H, S, dv)
    return torch.movedim(out, 1, 2)                      # (B, S, H, dv)


def sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool) -> torch.Tensor:
    """The ``sp_attn`` perf flag: q-sequence-split attention. Under a
    grid with ``model`` sites that divide S, each model site attends its
    slice of the queries against the whole K/V (the reference gathers
    the small GQA K/V once and keeps scores, softmax and PV local), and
    the sites' outputs are joined in site order; otherwise one pass over
    every query. fp32 scores and products (the reference's
    ``preferred_element_type``); ``bf16_probs`` rounds the
    probabilities to bf16. q: (B, S, H, dk), k / v: (B, S, Hkv, d*)."""
    B, S, H, dh = q.shape
    Hkv, dv = k.shape[2], v.shape[-1]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    g = perf_flags.abstract_mesh().shape.get("model", 1)
    g = g if S % g == 0 else 1
    kf = torch.movedim(k, 1, 2).float()[:, :, None]      # (B, Hkv, 1, S, d)
    vf = torch.movedim(v, 1, 2).float()[:, :, None]
    kpos = torch.arange(S, device=q.device)
    outs = []
    for r in range(g):
        lo, n = r * S // g, S // g
        qg = q[:, lo:lo + n].reshape(B, n, Hkv, rep, dh)
        qg = qg.permute(0, 2, 3, 1, 4).float()          # (B, Hkv, rep, n, d)
        s = torch.matmul(qg, kf.transpose(-1, -2)) * scale
        if causal:
            qpos = lo + torch.arange(n, device=q.device)
            s = s.masked_fill(~(kpos[None, :] <= qpos[:, None]),
                              float("-inf"))
        pr = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
        if perf_flags.enabled("bf16_probs"):
            pr = pr.bfloat16().float()
        o = torch.matmul(pr, vf)                         # (B, Hkv, rep, n, dv)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, n, H, dv))
    return site_all_gather(outs, dim=1).to(q.dtype)


def _attend(q, k, v, *, causal: bool, use_kernel: bool, q_chunk: int):
    """Attention over (B, S, H, d) q and (B, S, Hkv, d) k / v, by the
    reference's route: the kernels, else ``sp_attn``, else chunked."""
    if use_kernel:
        out = kops.fused_attention(torch.movedim(q, 2, 1),
                                   torch.movedim(k, 2, 1),
                                   torch.movedim(v, 2, 1), causal=causal)
        return torch.movedim(out, 1, 2)
    if perf_flags.enabled("sp_attn"):
        return sp_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, chunk=q_chunk)


def attention_train(p: AttnParams, x: torch.Tensor, *, n_heads: int,
                    n_kv: int, d_head: int, causal: bool, rope_theta: float,
                    rms_eps: float, use_kernel: bool = False,
                    q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention for training. x: (B, S, d).

    ``use_kernel`` runs ``fused_attention`` on (B, H, S, d) (the heads
    moved in front of the sequence, copied to contiguous by the wrapper);
    otherwise ``sp_attention`` under the ``sp_attn`` flag, else
    ``chunked_attention``. With the projections split whole heads a site
    (``tensor_parallel.head_sites``), each site projects, attends (its
    own kernel launch on H / g and Hkv / g heads) and multiplies by its
    rows of ``wo``, and the sites' partial outputs are summed in fp32 in
    site order and cast once.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    g = tp.head_sites(p.wq, p.wk, p.wv, p.wo, n_heads, n_kv)
    if g:
        partial = []
        for r in range(g):
            site = AttnParams(p.wq.parts[r], p.wk.parts[r], p.wv.parts[r],
                              p.wo.parts[r], p.q_norm, p.k_norm)
            q, k, v = _project_qkv(site, x, positions, n_heads // g,
                                   n_kv // g, d_head, rope_theta, rms_eps)
            out = _attend(q, k, v, causal=causal, use_kernel=use_kernel,
                          q_chunk=q_chunk)
            partial.append((out.reshape(B, S, -1) @ site.wo).float())
        return site_all_reduce(partial).to(x.dtype)
    q, k, v = _project_qkv(p, x, positions, n_heads, n_kv, d_head,
                           rope_theta, rms_eps)
    out = _attend(q, k, v, causal=causal, use_kernel=use_kernel,
                  q_chunk=q_chunk)
    return linear(out.reshape(B, S, n_heads * d_head), p.wo)


def attention_prefill(p: AttnParams, x: torch.Tensor, *, n_heads: int,
                      n_kv: int, d_head: int, causal: bool,
                      rope_theta: float, rms_eps: float,
                      q_chunk: int = 512):
    """Full-sequence attention that also returns the roped K/V in cache
    layout (B, Hkv, S, dh). x: (B, S, d)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, positions, n_heads, n_kv, d_head,
                           rope_theta, rms_eps)
    out = chunked_attention(q, k, v, causal=causal, chunk=q_chunk)
    out = linear(out.reshape(B, S, n_heads * d_head), p.wo)
    return out, torch.movedim(k, 2, 1), torch.movedim(v, 2, 1)


def attention_prefill_with_prefix(p: AttnParams, x: torch.Tensor,
                                  prefix_k: torch.Tensor,
                                  prefix_v: torch.Tensor,
                                  prefix_len: torch.Tensor, *, n_heads: int,
                                  n_kv: int, d_head: int, rope_theta: float,
                                  rms_eps: float):
    """Suffix prefill of a prefix-cache or chunked admission (plain
    tensor code, as in the reference).

    ``x`` holds only the novel tail of a prompt whose first
    ``prefix_len`` tokens already have cache-resident K/V. Queries are
    roped at absolute positions ``prefix_len + i`` and attend over the
    cached prefix (masked to its live length) and the suffix's own causal
    window, in one fp32 softmax: by causality this is what a from-scratch
    prefill computes for these positions.

    x: (B, S, d); prefix_k/v: (B, Hkv, P, dh) logical layout, post-RoPE,
    live below ``prefix_len`` (B,). Returns (out (B, S, d), k, v), k/v
    the suffix's roped K/V in cache layout (B, Hkv, S, dh).
    """
    B, S, _ = x.shape
    positions = (prefix_len[:, None].long()
                 + torch.arange(S, device=x.device)[None, :])
    q, k, v = _project_qkv(p, x, positions, n_heads, n_kv, d_head,
                           rope_theta, rms_eps)
    P = prefix_k.shape[2]
    rep = n_heads // n_kv
    scale = 1.0 / math.sqrt(d_head)
    qg = torch.movedim(q, 2, 1).reshape(B, n_kv, rep, S, d_head).float()
    kh = torch.movedim(k, 2, 1)                        # (B, Hkv, S, dh)
    vh = torch.movedim(v, 2, 1)
    s_pre = torch.matmul(qg, prefix_k.float()[:, :, None]
                         .transpose(-1, -2)) * scale   # (B,Hkv,rep,S,P)
    live = (torch.arange(P, device=x.device)[None, :]
            < prefix_len[:, None])                     # (B, P)
    s_pre = s_pre.masked_fill(~live[:, None, None, None, :], float("-inf"))
    s_suf = torch.matmul(qg, kh.float()[:, :, None].transpose(-1, -2)) * scale
    causal = (torch.arange(S, device=x.device)[None, :]
              <= torch.arange(S, device=x.device)[:, None])   # (Sq, Sk)
    s_suf = s_suf.masked_fill(~causal, float("-inf"))
    pr = torch.softmax(torch.cat([s_pre, s_suf], dim=-1), dim=-1)
    pr = torch.nan_to_num(pr, nan=0.0)
    out = (torch.matmul(pr[..., :P], prefix_v.float()[:, :, None])
           + torch.matmul(pr[..., P:], vh.float()[:, :, None]))
    out = out.to(x.dtype).reshape(B, n_heads, S, d_head)
    out = torch.movedim(out, 1, 2).reshape(B, S, n_heads * d_head)
    return linear(out, p.wo), kh, vh


def grouped_decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, live: torch.Tensor,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Repeat-free GQA masked decode attention (plain tensor code).

    q: (B, H, dh); caches (B, Hkv, Smax, dh); live: (B, Smax) bool.
    Returns (out (B, H, dh), mass (B, Smax)).
    """
    B, H, dh = q.shape
    Hkv = k_cache.shape[1]
    rep = H // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qg = q.float().reshape(B, Hkv, rep, dh)
    s = torch.matmul(qg, k_cache.float().transpose(-1, -2)) * scale
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.matmul(p, v_cache.float())
    n_live = torch.sum(live, dim=-1, keepdim=True).float()
    mass = torch.mean(p, dim=(1, 2)) * n_live
    return out.reshape(B, H, dh).to(q.dtype), mass


def dense_decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, kv_lens: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Default decode attention over the first ``kv_lens`` tokens."""
    Smax = k_cache.shape[2]
    live = torch.arange(Smax, device=q.device)[None, :] < kv_lens[:, None]
    return grouped_decode_attn(q, k_cache, v_cache, live)


def attention_decode(p: AttnParams, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_lens: torch.Tensor, *,
                     n_heads: int, n_kv: int, d_head: int, rope_theta: float,
                     rms_eps: float,
                     decode_attn_fn: DecodeAttnFn = dense_decode_attn,
                     paged: Optional[tuple] = None):
    """One decode step. x: (B, d) current-token activations.

    Writes the new token's K/V in place at ring slot ``kv_lens % W`` of
    the (B, Hkv, W, dh) cache (W == Smax is the full-window buffer) and
    attends over ``kv_lens + 1`` tokens. Returns (out (B, d), mass (B,
    Smax), k_cache, v_cache).

    ``paged=(pk, pv, dst_block, dst_slot)`` additionally mirrors the token
    into this layer's pool slice ((NB+1, bs, Hkv, dh); inactive rows are
    routed to the sentinel block) and calls ``decode_attn_fn(q, k_cache,
    v_cache, pk, pv, kv_lens)``; the return grows to (out, mass, k_cache,
    v_cache, pk, pv).

    The ``pam_shard_decode`` perf flag writes the token and attends in
    one sequence-sharded pass over the ambient grid's ``model`` sites
    (``pam_shard.fused_update_decode``; the cache is the full-window
    buffer, W == Smax), in place of ``decode_attn_fn``; it refuses paged
    pools, as the reference does.
    """
    B, d = x.shape
    q = linear(x, p.wq).reshape(B, n_heads, d_head)
    k = linear(x, p.wk).reshape(B, n_kv, d_head)
    v = linear(x, p.wv).reshape(B, n_kv, d_head)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, rms_eps)
        k = rms_norm(k, p.k_norm, rms_eps)
    pos = kv_lens
    q = apply_rope(q[:, None], pos[:, None], rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], rope_theta)[:, 0]

    if perf_flags.enabled("pam_shard_decode"):
        if paged is not None:
            raise ValueError("paged KV pools and the pam_shard_decode "
                             "perf flag are mutually exclusive")
        from repro_torch.distributed.pam_shard import fused_update_decode
        out, mass, k_cache, v_cache = fused_update_decode(
            q, k_cache, v_cache, k, v, kv_lens)
        return (linear(out.reshape(B, n_heads * d_head), p.wo), mass,
                k_cache, v_cache)

    # ring append: one write at pos % W is also the ring eviction (the
    # overwritten token lives on in its mapped pool block)
    bidx = torch.arange(B, device=x.device)
    slot = (pos % k_cache.shape[2]).long()
    k_cache[bidx, :, slot] = k
    v_cache[bidx, :, slot] = v
    if paged is not None:
        pk, pv, dst_block, dst_slot = paged
        pk[dst_block.long(), dst_slot.long()] = k
        pv[dst_block.long(), dst_slot.long()] = v
        out, mass = decode_attn_fn(q, k_cache, v_cache, pk, pv, kv_lens + 1)
        out = out.reshape(B, n_heads * d_head)
        return linear(out, p.wo), mass, k_cache, v_cache, pk, pv
    out, mass = decode_attn_fn(q, k_cache, v_cache, kv_lens + 1)
    return (linear(out.reshape(B, n_heads * d_head), p.wo), mass,
            k_cache, v_cache)
