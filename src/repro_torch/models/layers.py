"""Shared neural layers (plain functions on tensors).

Counterpart of ``repro.models.layers``: the same normalisation, init
scales, SwiGLU and RoPE, with weights kept in the JAX ``x @ W``
orientation so parameters cross the bridge as plain copies. Weight
products go through ``linear``, which also takes a sharded engine's
per-site slices (``distributed.tensor_parallel``).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import tensor_parallel as tp
# the models import ``linear`` from here
from repro_torch.distributed.tensor_parallel import linear  # noqa: F401


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32 and cast back to ``x.dtype``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(d_in, d_out) weight, N(0, 1/d_in) — the reference's scale."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / d_in ** 0.5)).to(dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return tp.swiglu(x, w_gate, w_up, w_down)


# ------------------------------------------------------------------- RoPE
def rope_freqs(d_head: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, d) or (..., S, d); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # (d/2,)
    angles = positions[..., None].float() * freqs        # (..., S, d/2)
    if x.dim() == angles.dim() + 1:                      # has head axis
        angles = angles[..., None, :]                    # (..., S, 1, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
