"""Multi-head Latent Attention (DeepSeek-V2): train, prefill and the
absorbed decode.

Counterpart of ``repro.models.mla``. The decode cache holds only the
rank-r latent ``c_kv`` and the shared RoPE key, so PAM's tiering,
importance and scheduling run on *latent* tokens. Decode uses the
absorbed form: W_uk is folded into the query and W_uv applied after
attention, so the cached latent is both key and value (MQA-like, d_k =
r + rope_dim, d_v = r). The reference computes these products with
``einsum``s outside any Pallas kernel, and so does the port: fp32
scores and probabilities, plain tensor code. Decode writes the new
token's latent and rope key in place at position ``kv_lens`` of every
row (a finished or idle row writes below ``max_len`` too, as admission
keeps every request inside it), so a CUDA graph can hold the step.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.attention import chunked_attention
from repro_torch.models.config import MLAConfig
from repro_torch.models.layers import apply_rope, init_linear, rms_norm


class MLAParams(NamedTuple):
    wq: torch.Tensor        # (d, H*(nope+rope))
    w_dkv: torch.Tensor     # (d, r)
    kv_norm: torch.Tensor   # (r,)
    w_kr: torch.Tensor      # (d, rope_dim)  shared per-token rope key
    w_uk: torch.Tensor      # (r, H*nope)
    w_uv: torch.Tensor      # (r, H*vd)
    wo: torch.Tensor        # (H*vd, d)


def init_mla(gen: torch.Generator, d: int, n_heads: int, cfg: MLAConfig,
             dtype: torch.dtype, device: torch.device) -> MLAParams:
    """One layer's weights at the reference's scales (``init_linear``:
    N(0, 1/d_in)), the latent norm's weight at one."""
    H = n_heads
    r, dn = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    dr, dv = cfg.qk_rope_head_dim, cfg.v_head_dim

    def lin(d_in, d_out):
        return init_linear(gen, d_in, d_out, dtype, device)
    return MLAParams(
        wq=lin(d, H * (dn + dr)), w_dkv=lin(d, r),
        kv_norm=torch.ones((r,), dtype=dtype, device=device),
        w_kr=lin(d, dr), w_uk=lin(r, H * dn), w_uv=lin(r, H * dv),
        wo=lin(H * dv, d))


def _latent(p: MLAParams, x: torch.Tensor, positions: torch.Tensor,
            rope_theta: float, rms_eps: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cached pair of x (B, S, d): the normed latent (B, S, r) and
    the roped shared key (B, S, 1, dr)."""
    c_kv = rms_norm(x @ p.w_dkv, p.kv_norm, rms_eps)
    k_rope = apply_rope((x @ p.w_kr)[:, :, None, :], positions, rope_theta)
    return c_kv, k_rope


def mla_train(p: MLAParams, x: torch.Tensor, cfg: MLAConfig, *,
              n_heads: int, rope_theta: float, rms_eps: float,
              causal: bool = True, q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence MLA. x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    H = n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    positions = torch.arange(S, device=x.device).expand(B, S)

    q = (x @ p.wq).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, rope_theta)

    c_kv, k_rope = _latent(p, x, positions, rope_theta, rms_eps)
    k_nope = (c_kv @ p.w_uk).reshape(B, S, H, dn)
    v = (c_kv @ p.w_uv).reshape(B, S, H, dv)
    k_rope = k_rope.expand(B, S, H, dr)

    qh = torch.cat([q_nope, q_rope], dim=-1)
    kh = torch.cat([k_nope, k_rope], dim=-1)
    scale = 1.0 / math.sqrt(dn + dr)
    out = chunked_attention(qh, kh, v, causal=causal, chunk=q_chunk,
                            scale=scale)                 # (B, S, H, dv)
    return out.reshape(B, S, H * dv) @ p.wo


def mla_prefill(p: MLAParams, x: torch.Tensor, cfg: MLAConfig, *,
                n_heads: int, rope_theta: float, rms_eps: float,
                causal: bool = True, q_chunk: int = 512
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mla_train`` and the latent cache of x: (out (B, S, d), c_kv
    (B, S, r), k_rope (B, S, dr))."""
    B, S, d = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    out = mla_train(p, x, cfg, n_heads=n_heads, rope_theta=rope_theta,
                    rms_eps=rms_eps, causal=causal, q_chunk=q_chunk)
    c_kv, k_rope = _latent(p, x, positions, rope_theta, rms_eps)
    return out, c_kv, k_rope[:, :, 0]


def latent_attention(q_eff: torch.Tensor, kv_latent: torch.Tensor,
                     k_rope: torch.Tensor, live: torch.Tensor, scale: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absorbed attention over the latent tokens where ``live`` (B, Smax)
    holds: (latent output (B, H, r) in q_eff's dtype, fp32 probabilities
    (B, H, Smax), 0 on every row with nothing live)."""
    k_eff = torch.cat([kv_latent, k_rope], dim=-1)       # (B, S, r+dr)
    s = torch.matmul(q_eff.float(), k_eff.float().transpose(1, 2)) * scale
    s = s.masked_fill(~live[:, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.matmul(p, kv_latent.float())
    return out.to(q_eff.dtype), p


def mla_latent_decode_attn(q_eff: torch.Tensor, kv_latent: torch.Tensor,
                           k_rope: torch.Tensor, kv_lens: torch.Tensor, *,
                           scale: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Absorbed-MLA decode attention over the first ``kv_lens`` latent
    tokens.

    q_eff: (B, H, r + dr); kv_latent: (B, Smax, r); k_rope: (B, Smax,
    dr). Returns (latent output (B, H, r), mass (B, Smax): the head-mean
    probability times ``kv_lens``), as the reference's.
    """
    Smax = kv_latent.shape[1]
    live = (torch.arange(Smax, device=q_eff.device)[None, :]
            < kv_lens[:, None])
    out, p = latent_attention(q_eff, kv_latent, k_rope, live, scale)
    return out, torch.mean(p, dim=1) * kv_lens[:, None].float()


def mla_decode(p: MLAParams, x: torch.Tensor, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, kv_lens: torch.Tensor,
               cfg: MLAConfig, *, n_heads: int, rope_theta: float,
               rms_eps: float,
               latent_attn_fn: Callable = mla_latent_decode_attn):
    """One decode step. x: (B, d); caches ckv (B, Smax, r) and krope
    (B, Smax, dr), written in place at position ``kv_lens`` of every
    row. Returns (out (B, d), mass (B, Smax), ckv_cache, krope_cache)."""
    B, d = x.shape
    H = n_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    pos = kv_lens

    q = (x @ p.wq).reshape(B, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope.reshape(B, 1, H, dr), pos[:, None],
                        rope_theta).reshape(B, H, dr)

    c_kv = rms_norm(x @ p.w_dkv, p.kv_norm, rms_eps)
    k_rope = apply_rope((x @ p.w_kr)[:, None, :], pos[:, None],
                        rope_theta)[:, 0]                # (B, dr)

    bidx = torch.arange(B, device=x.device)
    ckv_cache[bidx, pos.long()] = c_kv
    krope_cache[bidx, pos.long()] = k_rope

    # absorb W_uk into the query: q_lat[h] = q_nope[h] @ W_uk[:, h]^T
    w_uk = p.w_uk.reshape(r, H, dn)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)
    q_eff = torch.cat([q_lat, q_rope], dim=-1)           # (B, H, r+dr)

    scale = 1.0 / math.sqrt(dn + dr)
    o_lat, mass = latent_attn_fn(q_eff, ckv_cache, krope_cache, kv_lens + 1,
                                 scale=scale)            # (B, H, r)
    w_uv = p.w_uv.reshape(r, H, dv)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv).reshape(B, H * dv)
    return o @ p.wo, mass, ckv_cache, krope_cache
