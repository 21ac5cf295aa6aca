"""GQA attention (train, prefill, decode) with optional qk-norm and RoPE.

Counterpart of ``repro.models.attention``. ``attention_train`` runs the
``flash_attention`` kernels (``use_kernel=True``) or q-chunked attention
in plain tensor code, which stays differentiable. Prefill runs q-chunked
attention in plain tensor code, as the reference's serving prefill
does. Decode attention is injectable through ``decode_attn_fn`` (the
PAM manager's tiered attention in the engine); the default is dense
grouped attention. Decode appends write the caches
in place: the ring slot ``pos % W`` of the dense buffer and, in paged
mode, the token's (block, slot) in the pool.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, rms_norm

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
    q = (x @ p.wq).reshape(B, S, n_heads, d_head)
    k = (x @ p.wk).reshape(B, S, n_kv, d_head)
    v = (x @ p.wv).reshape(B, S, n_kv, d_head)
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
    fp32 softmax, q-chunked (peak intermediate (B, H, chunk, S))."""
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
        outs.append(torch.matmul(p, vh[:, :, None]).to(q.dtype))
    out = torch.cat(outs, dim=3).reshape(B, H, S, dv)
    return torch.movedim(out, 1, 2)                      # (B, S, H, dv)


def attention_train(p: AttnParams, x: torch.Tensor, *, n_heads: int,
                    n_kv: int, d_head: int, causal: bool, rope_theta: float,
                    rms_eps: float, use_kernel: bool = False,
                    q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention for training. x: (B, S, d).

    ``use_kernel`` runs ``fused_attention`` on (B, H, S, d) (the heads
    moved in front of the sequence, copied to contiguous by the wrapper);
    otherwise ``chunked_attention``. The reference's ``sp_attn`` and
    ``bf16_probs`` perf flags are not ported (ROADMAP Queue 1 item 10).
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, positions, n_heads, n_kv, d_head,
                           rope_theta, rms_eps)
    if use_kernel:
        out = kops.fused_attention(torch.movedim(q, 2, 1),
                                   torch.movedim(k, 2, 1),
                                   torch.movedim(v, 2, 1), causal=causal)
        out = torch.movedim(out, 1, 2)
    else:
        out = chunked_attention(q, k, v, causal=causal, chunk=q_chunk)
    return out.reshape(B, S, n_heads * d_head) @ p.wo


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
    out = out.reshape(B, S, n_heads * d_head) @ p.wo
    return out, torch.movedim(k, 2, 1), torch.movedim(v, 2, 1)


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
    """
    B, d = x.shape
    q = (x @ p.wq).reshape(B, n_heads, d_head)
    k = (x @ p.wk).reshape(B, n_kv, d_head)
    v = (x @ p.wv).reshape(B, n_kv, d_head)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, rms_eps)
        k = rms_norm(k, p.k_norm, rms_eps)
    pos = kv_lens
    q = apply_rope(q[:, None], pos[:, None], rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], rope_theta)[:, 0]

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
        return out @ p.wo, mass, k_cache, v_cache, pk, pv
    out, mass = decode_attn_fn(q, k_cache, v_cache, kv_lens + 1)
    return out.reshape(B, n_heads * d_head) @ p.wo, mass, k_cache, v_cache
